"""Free-surface machinery: trace transfer, kinematic/dynamic RHS, relaxation zones.

JAX re-design of the ``rhs_linear : TimeDependentOperator`` class the
reference clones into all nine solver programs (canonical copies:
``Solvers/PF_linear_periodic.cpp:14-104`` for the bare operator,
``Solvers/PF_linear_serial.cpp:57-262`` with embedded penalty forcing).

Physics (the linearized free-surface conditions):
    d eta / dt    = w_tilde = dphi/dz |_fs
    d phi_fs / dt = -g eta
with the volume potential phi solving Laplace's equation, Dirichlet
phi = phi_fs on the free surface (attr 2), natural walls elsewhere, plus the
optional relaxation-zone penalty forcing
    dt g += alpha(t) * C(x)/tau * (g_e - g)
(``Solvers/PF_linear_serial.cpp:186-257``).

The whole RHS — transfer, preconditioned CG Laplace solve, z-derivative,
surface ODEs, penalty forcing — is one pure jit-compatible function of
``(t, state, phi_carry)``. The volume potential is threaded through as a
carry purely as the CG warm start, exactly mirroring MFEM's persistent
``GridFunction &phi`` across ``Mult`` calls.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .analytic import AiryWave
from .operators import LaplacePA, NodalZDerivative
from .solvers import pcg, pcg_ir
from .space import SurfaceSpace

__all__ = [
    "cgen_weight", "cabs_weight", "RelaxationZones", "FreeSurfaceOperator",
    "SolveInfo", "SolveStats", "SolveCarry",
]


class SolveInfo(NamedTuple):
    """Per-solve convergence telemetry (the data MFEM's CGSolver prints —
    iteration count and the final 'No convergence!' check,
    ``Solvers/laplace_solver.cpp:113`` path — which the reference's time
    loops otherwise discard)."""
    iters: jax.Array        # int32 — total (inner) CG iterations
    converged: jax.Array    # bool  — final residual met the threshold
    rz: jax.Array           # final (preconditioned/outer) residual measure
    rz0: jax.Array


class SolveStats(NamedTuple):
    """Running aggregate of :class:`SolveInfo` across RK4 stages/steps."""
    max_iters: jax.Array    # int32 — worst single-solve iteration count
    unconverged: jax.Array  # bool  — any stage exited above its threshold

    @classmethod
    def zero(cls) -> "SolveStats":
        return cls(max_iters=jnp.asarray(0, dtype=jnp.int32),
                   unconverged=jnp.asarray(False))

    def update(self, info: SolveInfo) -> "SolveStats":
        return SolveStats(
            max_iters=jnp.maximum(self.max_iters, info.iters),
            unconverged=jnp.logical_or(self.unconverged,
                                       jnp.logical_not(info.converged)))


class SolveCarry(NamedTuple):
    """RK4 aux carry with telemetry: the volume-potential warm start plus
    aggregated solver stats. :meth:`FreeSurfaceOperator.__call__` accepts
    either a bare ``phi`` array or this (the carry pytree must be chosen
    before entering a ``lax.scan``, so the caller decides — ``Problem.run``
    always threads the telemetry form)."""
    phi: jax.Array
    stats: SolveStats


def cgen_weight(x: np.ndarray, xg0: float, xg1: float) -> np.ndarray:
    """Generation-zone forcing weight: 1 at the inlet (x<=xg0), cubic
    smoothstep down to 0 at xg1 (``Solvers/PF_linear_serial.cpp:397-408``)."""
    xi = np.clip((x - xg0) / (xg1 - xg0), 0.0, 1.0)
    s = 1.0 - xi
    return -2.0 * s ** 3 + 3.0 * s ** 2


def cabs_weight(x: np.ndarray, x0: float, x1: float, p: float = 5.0) -> np.ndarray:
    """Absorption-zone weight: 0 at x0 rising as xi^p to 1 at the outlet x1
    (``Solvers/PF_linear_serial.cpp:417-430``)."""
    xi = np.clip((x - x0) / (x1 - x0), 0.0, 1.0)
    return xi ** p


@dataclass
class RelaxationZones:
    """Precomputed penalty-forcing data on the surface nodes.

    ``cgen``/``cabs`` are nodal weights (build with :func:`cgen_weight` /
    :func:`cabs_weight`; sum lateral zones like the cylinder case's ``Cabsy``
    (``Solvers/cylinder-diffraction.cpp:373-389``) into ``cabs``).
    The target wave enters through its surface-node phase tables so the RHS
    needs only scalar trig of ``omega * t`` at run time.
    """
    cgen: jax.Array          # [Ns]
    cabs: jax.Array          # [Ns]
    cos_kx: jax.Array        # [Ns] cos(k (kx x + ky y)) at surface nodes
    sin_kx: jax.Array        # [Ns]
    H: float
    omega: float
    phi_amp: float           # -H/2 c cosh(kh)/sinh(kh)
    tau: float               # penalty timescale (= dt in the reference)
    T: float                 # wave period, for the generation ramp
    n_ramp: float = 3.0      # ramp periods (``Solvers/PF_linear_serial.cpp:237-241``)

    @classmethod
    def build(cls, surf: SurfaceSpace, wave: AiryWave, tau: float,
              cgen: np.ndarray | None = None, cabs: np.ndarray | None = None,
              n_ramp: float = 3.0, dtype=jnp.float64) -> "RelaxationZones":
        X = surf.node_coords
        ns = surf.n_dofs
        karg = wave.k * (wave.kx * X[:, 0] + wave.ky * X[:, 1])
        zero = np.zeros(ns)
        return cls(
            cgen=jnp.asarray(zero if cgen is None else cgen, dtype=dtype),
            cabs=jnp.asarray(zero if cabs is None else cabs, dtype=dtype),
            cos_kx=jnp.asarray(np.cos(karg), dtype=dtype),
            sin_kx=jnp.asarray(np.sin(karg), dtype=dtype),
            H=float(wave.H), omega=float(wave.omega),
            phi_amp=float(-0.5 * wave.H * wave.c * np.cosh(wave.kh) / np.sinh(wave.kh)),
            tau=float(tau), T=float(wave.T), n_ramp=float(n_ramp),
        )

    def targets(self, t):
        """(eta_e, phi_fs_e) at stage time t: the Airy wave, via angle sums."""
        c, s = jnp.cos(self.omega * t), jnp.sin(self.omega * t)
        # cos(wt - kx) = cos wt cos kx + sin wt sin kx
        eta_e = 0.5 * self.H * (c * self.cos_kx + s * self.sin_kx)
        # sin(wt - kx) = sin wt cos kx - cos wt sin kx
        phi_e = self.phi_amp * (s * self.cos_kx - c * self.sin_kx)
        return eta_e, phi_e


class FreeSurfaceOperator:
    """The reference's ``rhs_linear::Mult`` as a pure function.

    state y = concat([eta, phi_fs]) on the surface dofs; returns
    (dy/dt, phi) where phi is the converged volume potential (carried forward
    as the next stage's CG warm start).
    """

    def __init__(self, op: LaplacePA, surf: SurfaceSpace,
                 g: float = 9.81,
                 relax: RelaxationZones | None = None,
                 cg_rtol_sq: float = 1e-24, cg_atol_sq: float = 0.0,
                 cg_max_iter: int = 1000,
                 precond_fn=None,
                 op_hi: LaplacePA | None = None,
                 ir_max_outer: int = 4, ir_inner_rtol_sq: float = 1e-8,
                 op_solve=None, hi_apply: str = "auto"):
        """``op_hi`` switches the Laplace solve to mixed precision: ``op``
        (f32) powers the inner CG + preconditioner, ``op_hi`` (f64) the outer
        true residuals and the z-derivative (``solvers.pcg_ir``) — MFEM's
        double-precision tolerances at near-f32 speed
        (``Solvers/PF_linear_par_partial.cpp:157-164``).

        ``op_solve`` overrides the operator driving the CG solve (e.g. the
        fully-assembled ELL :class:`~lpfem.operators.AssembledLaplace`, the
        ``PF_linear_par`` full-assembly mode,
        ``Solvers/PF_linear_par.cpp:114-120``); ``op`` keeps providing
        geometry-derived roles (z-derivative, norms)."""
        self.op = op
        self.op_hi = op_hi
        self.op_solve = op_solve if op_solve is not None else op
        self.surf = surf
        self.g = g
        self.relax = relax
        self.cg_rtol_sq = cg_rtol_sq
        self.cg_atol_sq = cg_atol_sq
        self.cg_max_iter = cg_max_iter
        self.ir_max_outer = ir_max_outer
        self.ir_inner_rtol_sq = ir_inner_rtol_sq
        self.n_surf = surf.n_dofs

        s2v = surf.surf_to_vol
        if len(np.unique(s2v)) != len(s2v):
            raise AssertionError("surface->volume dof map is not injective")
        self.ess = jnp.asarray(s2v.astype(np.int32))
        if hasattr(op, "enable_top_plane_ess"):
            op.enable_top_plane_ess(s2v)   # in-kernel constraint fast path
        self.zderiv = NodalZDerivative(op_hi if op_hi is not None else op)
        self._zd_top = self.zderiv.enable_top_trace(s2v)
        # Jacobi preconditioner diagonal with identity on essential dofs
        diag_c = self.op_solve.diag.at[self.ess].set(1.0)
        self._inv_diag = 1.0 / diag_c
        self._precond = precond_fn if precond_fn is not None \
            else (lambda r: r * self._inv_diag)

        # outer arithmetic of the mixed solve: "auto"/"f64" run pcg_ir's
        # outer loop in native f64; "ds" runs it in double-single (two-f32)
        # arithmetic (solvers.pcg_ir_ds, lpfem.ds), a scheme for hardware
        # that emulates f64 — kept selectable so its cost can be compared.
        if hi_apply not in ("auto", "ds", "f64"):
            raise ValueError(f"unknown hi_apply {hi_apply!r}")
        self._ds_op = None
        if (hi_apply == "ds" and op_hi is not None
                and getattr(op_hi, "sep", None) is not None
                and getattr(op, "_ess_top", False)):
            from .ds import SeparableDS
            self._ds_op = SeparableDS(op_hi.sep)
        if hi_apply == "ds" and self._ds_op is None:
            raise ValueError("hi_apply='ds' needs dtype='mixed' on a "
                             "separable lattice with the top-plane "
                             "essential set")

    def register_params(self, bp) -> None:
        """Thread large buffers as jit arguments (lpfem.params)."""
        self.op.register_params(bp)
        if self.op_solve is not self.op:
            self.op_solve.register_params(bp)
        if self.op_hi is not None:
            # outer f64 operator: residual applies only, never preconditions
            self.op_hi.register_params(bp, need_diag=False)
        self.zderiv.register_params(bp)
        bp.register(self, "_inv_diag", "ess")
        if self.relax is not None:
            bp.register(self.relax, "cgen", "cabs", "cos_kx", "sin_kx")
        if hasattr(self._precond, "register_params"):
            self._precond.register_params(bp)

    # ------------------------------------------------------------- laplace
    def solve_laplace(self, phi_fs: jax.Array, phi_warm: jax.Array):
        """Dirichlet Laplace solve: phi = phi_fs on the free surface,
        zero-Neumann elsewhere (``Solvers/PF_linear_periodic.cpp:71-92``)."""
        op, ess = self.op, self.ess
        if self._ds_op is not None:
            return self._solve_laplace_ds(phi_fs, phi_warm)
        if self.op_hi is not None:
            oph = self.op_hi
            b = jnp.zeros(oph.n_dofs, dtype=phi_warm.dtype)
            B, _ = oph.constrained_rhs(b, ess, phi_fs)
            x0 = phi_warm.at[ess].set(phi_fs)
            res = pcg_ir(lambda v: oph.constrained_apply(v, ess),
                         lambda v: op.constrained_apply(v, ess), B, x0,
                         precond_lo=self._precond,
                         rtol_sq=self.cg_rtol_sq, atol_sq=self.cg_atol_sq,
                         max_outer=self.ir_max_outer,
                         inner_rtol_sq=self.ir_inner_rtol_sq,
                         inner_max_iter=self.cg_max_iter)
            return res.x, self._info(res)
        sop = self.op_solve
        b = jnp.zeros(sop.n_dofs, dtype=phi_warm.dtype)
        B, _ = sop.constrained_rhs(b, ess, phi_fs)
        x0 = phi_warm.at[ess].set(phi_fs)
        res = pcg(lambda v: sop.constrained_apply(v, ess), B, x0,
                  precond_fn=self._precond,
                  rtol_sq=self.cg_rtol_sq, atol_sq=self.cg_atol_sq,
                  max_iter=self.cg_max_iter)
        return res.x, self._info(res)

    def _solve_laplace_ds(self, phi_fs: jax.Array, phi_warm):
        """Double-single mixed solve: outer residual loop in two-f32 pairs
        (``solvers.pcg_ir_ds`` + ``ds.SeparableDS``), inner f32 CG
        unchanged. ``phi_warm`` may be a DS pair (the carried warm start)
        or a plain f64/f32 array (cold start); the returned ``phi`` is a
        DS pair, which ``Problem.run`` threads through the RK4 carry."""
        from .ds import DS, ds_from_f64
        from .solvers import pcg_ir_ds

        ess = self.ess
        dsop = self._ds_op
        vals = (ds_from_f64(phi_fs) if phi_fs.dtype == jnp.float64
                else DS(phi_fs.astype(jnp.float32),
                        jnp.zeros_like(phi_fs, dtype=jnp.float32)))
        n = self.op_hi.n_dofs
        # eliminated RHS of the zero-source Dirichlet system:
        # B = -A x_bc on free dofs, B[ess] = phi_fs (constrained_rhs with
        # b = 0, ``Solvers/PF_linear_periodic.cpp:71-92``)
        xbh = jnp.zeros(n, jnp.float32).at[ess].set(vals.hi)
        xbl = jnp.zeros(n, jnp.float32).at[ess].set(vals.lo)
        y = dsop.apply(DS(xbh, xbl))
        B = DS((-y.hi).at[ess].set(vals.hi), (-y.lo).at[ess].set(vals.lo))
        if isinstance(phi_warm, DS):
            w = phi_warm
        elif phi_warm.dtype == jnp.float64:
            w = ds_from_f64(phi_warm)
        else:
            w = DS(phi_warm.astype(jnp.float32),
                   jnp.zeros_like(phi_warm, dtype=jnp.float32))
        x0 = DS(w.hi.at[ess].set(vals.hi), w.lo.at[ess].set(vals.lo))
        res = pcg_ir_ds(dsop.constrained_apply_top,
                        lambda v: self.op.constrained_apply(v, ess),
                        B, x0, precond_lo=self._precond,
                        rtol_sq=self.cg_rtol_sq, atol_sq=self.cg_atol_sq,
                        max_outer=self.ir_max_outer,
                        inner_rtol_sq=self.ir_inner_rtol_sq,
                        inner_max_iter=self.cg_max_iter)
        return res.x, self._info(res)

    def _info(self, res) -> SolveInfo:
        """Convergence verdict under the MFEM threshold semantics the solve
        ran with (a max_iter / breakdown / NaN exit all report converged ==
        False; NaN because IEEE comparisons with NaN are False)."""
        threshold = jnp.maximum(res.rz0 * self.cg_rtol_sq, self.cg_atol_sq)
        return SolveInfo(iters=res.iters, converged=res.rz <= threshold,
                         rz=res.rz, rz0=res.rz0)

    # ----------------------------------------------------------------- rhs
    def __call__(self, t, y: jax.Array, aux):
        ns = self.n_surf
        eta, phi_fs = y[:ns], y[ns:]

        # aux is either the bare volume-potential warm start or a
        # SolveCarry(phi, stats) threading convergence telemetry — the
        # branch is static (pytree structure), so both compile cleanly.
        telemetry = isinstance(aux, SolveCarry)
        phi = aux.phi if telemetry else aux

        phi, info = self.solve_laplace(phi_fs, phi)

        if self._zd_top:
            w_tilde = self.zderiv.top_trace(phi)
        else:
            w_tilde = self.zderiv(phi)[self.ess]

        deta = w_tilde
        dphi_fs = -self.g * eta

        if self.relax is not None:
            rz = self.relax
            eta_e, phi_e = rz.targets(t)
            alpha_gen = jnp.clip(t / (rz.n_ramp * rz.T), 0.0, 1.0)
            inv_tau = 1.0 / rz.tau
            gen_w = alpha_gen * rz.cgen * inv_tau
            deta = deta + gen_w * (eta_e - eta) - rz.cabs * inv_tau * eta
            dphi_fs = dphi_fs + gen_w * (phi_e - phi_fs) - rz.cabs * inv_tau * phi_fs

        aux_out = SolveCarry(phi, aux.stats.update(info)) if telemetry else phi
        return jnp.concatenate([deta, dphi_fs]), aux_out
