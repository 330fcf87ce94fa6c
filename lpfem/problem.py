"""Problem assembly: Config -> mesh -> spaces -> operators -> time loop.

This is the library layer the reference lacks — each of its 21 programs
re-instantiates the same pipeline by hand (SURVEY.md 'What the reference is');
here :class:`Problem` builds it once from a :class:`~lpfem.configs.Config`
and exposes jitted step/run entry points.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .analytic import AiryWave
from .configs import Config
from .mesh import Mesh, load_gmsh, load_mfem, make_wave_tank, make_wave_tank_finite
from .operators import LaplacePA
from .space import H1Space, SurfaceSpace
from .surface import FreeSurfaceOperator, RelaxationZones, cabs_weight, cgen_weight
from .timestep import rk4_run, rk4_step

__all__ = ["Problem"]


def build_mesh(cfg: Config) -> Mesh:
    if cfg.mesh_kind == "periodic_tank":
        m = make_wave_tank(cfg.nx, cfg.ny, cfg.nz, cfg.Lx, cfg.Ly, cfg.Lz)
    elif cfg.mesh_kind == "finite_tank":
        m = make_wave_tank_finite(cfg.nx, cfg.ny, cfg.nz, cfg.Lx, cfg.Ly, cfg.Lz)
    elif cfg.mesh_kind == "mfem":
        m = load_mfem(cfg.mesh_file)
    elif cfg.mesh_kind == "gmsh":
        m = load_gmsh(cfg.mesh_file)
    else:
        raise ValueError(f"unknown mesh_kind {cfg.mesh_kind!r}")
    for _ in range(cfg.ref_levels):
        m = m.uniform_refine()
    return m


def build_wave(cfg: Config, mesh: Mesh) -> AiryWave:
    bbmin, bbmax = mesh.bounding_box()
    h = float(bbmax[2] - bbmin[2])
    z_top = float(bbmax[2])
    if cfg.wave_by == "modes":
        Lx = float(bbmax[0] - bbmin[0])
        return AiryWave.from_modes(H=cfg.H, m=cfg.wave_m, Lx=Lx, h=h,
                                   g=cfg.g, theta=cfg.theta, z_top=z_top)
    if cfg.wave_by == "period":
        return AiryWave.from_period(H=cfg.H, T=cfg.wave_T, h=h, g=cfg.g,
                                    theta=cfg.theta, z_top=z_top)
    if cfg.wave_by == "wavelength":
        k = 2.0 * np.pi / cfg.wave_lambda
        if cfg.kh_override is not None:
            # flagship convention (``Solvers/PF_linear_par_partial.cpp:297-302``):
            # k from lambda, kh pinned, c = sqrt(g/k tanh(kh)), T = lambda/c.
            # Use an effective depth h_eff = kh/k in the Airy fields.
            h_eff = cfg.kh_override / k
            return AiryWave(H=cfg.H, k=k, h=h_eff, g=cfg.g, theta=cfg.theta,
                            z_top=z_top)
        return AiryWave(H=cfg.H, k=k, h=h, g=cfg.g, theta=cfg.theta, z_top=z_top)
    raise ValueError(f"unknown wave_by {cfg.wave_by!r}")


class Problem:
    """A fully assembled LPF wave problem (single device)."""

    def __init__(self, cfg: Config, mesh: Mesh | None = None,
                 build_precond: bool = True):
        """``build_precond=False`` skips the single-device preconditioner
        (and its setup-time power iterations) — used by the sharded runner,
        which builds its own sharded hierarchy instead."""
        self.cfg = cfg
        # dtype="mixed": f64 state + outer residuals, f32 operator/precond
        # for the hot inner CG (solvers.pcg_ir) — MFEM's double tolerances
        # at near-f32 speed (``Solvers/PF_linear_par_partial.cpp:157-164``)
        self.mixed = cfg.dtype == "mixed"
        self.dtype = jnp.dtype("float64" if self.mixed else cfg.dtype)
        self.mesh = mesh if mesh is not None else build_mesh(cfg)
        self.wave = build_wave(cfg, self.mesh)
        self.space = H1Space(self.mesh, cfg.order)
        op_dtype = jnp.float32 if self.mixed else self.dtype
        assembled = cfg.apply_mode == "assembled"
        if assembled and self.mixed:
            raise ValueError("apply_mode='assembled' + dtype='mixed' is not "
                             "supported (the mixed inner solve is the PA "
                             "path); use float64 or float32")
        pa_mode = "fused" if assembled else cfg.apply_mode
        op_prec = cfg.mixed_inner_precision if self.mixed else None
        self.op = LaplacePA(self.space, q=cfg.quad, dtype=op_dtype,
                            mode=pa_mode, precision=op_prec)
        self.op_hi = (LaplacePA(self.space, q=cfg.quad, dtype=jnp.float64,
                                mode=pa_mode)
                      if self.mixed else None)
        # full-assembly mode (the PF_linear_par configuration,
        # ``Solvers/PF_linear_par.cpp:114-120``): the CG solve runs the
        # assembled ELL SpMV; the PA operator keeps the geometry roles
        self.op_solve = None
        if assembled:
            from .operators import AssembledLaplace
            self.op_solve = AssembledLaplace(self.op)
        self.surf = SurfaceSpace(self.space, attr=2)

        self.dt = float(cfg.t_final_periods * self.wave.T / cfg.nsteps)
        self.t_final = float(cfg.t_final_periods * self.wave.T)

        relax = None
        if cfg.relax:
            bbmin, bbmax = self.mesh.bounding_box()
            X = self.surf.node_coords[:, 0]
            lam = self.wave.wavelength
            cgen = cgen_weight(X, float(bbmin[0]), float(bbmin[0]) + cfg.Ng * lam)
            cabs = cabs_weight(X, float(bbmax[0]) - cfg.Ns * lam, float(bbmax[0]),
                               p=cfg.abs_power)
            relax = RelaxationZones.build(self.surf, self.wave, tau=self.dt,
                                          cgen=cgen, cabs=cabs,
                                          n_ramp=cfg.n_ramp, dtype=self.dtype)
        self.relax = relax

        precond_fn = None
        if not build_precond:
            pass
        elif cfg.precond == "pmg":
            from .multigrid import PMultigrid
            precond_fn = PMultigrid(self.op, smooth_degree=cfg.cheb_degree,
                                    h_coarsen_min_dofs=cfg.h_coarsen_min_dofs,
                                    ess_dofs=np.asarray(self.surf.surf_to_vol))
        elif cfg.precond == "chebyshev":
            from .multigrid import ChebyshevSmoother, estimate_lmax
            ess = jnp.asarray(self.surf.surf_to_vol)
            inv_diag = 1.0 / self.op.diag.at[ess].set(1.0)
            apply_c = lambda v: self.op.constrained_apply(v, ess)
            lmax = estimate_lmax(apply_c, inv_diag, self.space.n_dofs,
                                 dtype=self.op.dtype)
            precond_fn = ChebyshevSmoother(apply_c, inv_diag, lmax,
                                           degree=cfg.cheb_degree)
        elif cfg.precond != "jacobi":
            raise ValueError(f"unknown precond {cfg.precond!r}")

        self.fso = FreeSurfaceOperator(
            self.op, self.surf, g=cfg.g, relax=relax,
            cg_rtol_sq=cfg.cg_rtol_sq, cg_atol_sq=cfg.cg_atol_sq,
            cg_max_iter=cfg.cg_max_iter, precond_fn=precond_fn,
            op_hi=self.op_hi, ir_max_outer=cfg.ir_max_outer,
            ir_inner_rtol_sq=cfg.ir_inner_rtol_sq, op_solve=self.op_solve,
            hi_apply=cfg.hi_apply)

        # big-buffer registry: jit entry points thread these as arguments
        # instead of HLO constants (lpfem.params; required at 10M+ dofs)
        from .params import BigParams
        self.params = BigParams()
        self.fso.register_params(self.params)
        self._compiled = {}

    # ----------------------------------------------------------- initial data
    def initial_state(self, t: float = 0.0):
        """(y0, phi0): surface state [eta; phi_fs] + volume potential carry,
        projected from the Airy wave at time ``t`` (the reference's ICs,
        ``Solvers/PF_linear_par_partial.cpp:365-414``)."""
        w = self.wave
        eta0 = self.surf.project(lambda x, y, z: w.eta(x, y, t))
        pfs0 = self.surf.project(lambda x, y, z: w.phi_fs(x, y, t))
        y0 = jnp.concatenate([jnp.asarray(eta0, dtype=self.dtype),
                              jnp.asarray(pfs0, dtype=self.dtype)])
        phi0 = jnp.zeros(self.space.n_dofs, dtype=self.dtype)
        phi0 = phi0.at[self.fso.ess].set(jnp.asarray(pfs0, dtype=self.dtype))
        return y0, phi0

    def zero_state(self):
        ns = self.surf.n_dofs
        return (jnp.zeros(2 * ns, dtype=self.dtype),
                jnp.zeros(self.space.n_dofs, dtype=self.dtype))

    # ------------------------------------------------------------------- run
    def step_fn(self):
        """Jittable single RK4 step: (t, y, phi) -> (y, phi)."""
        fso, dt = self.fso, self.dt

        def step(t, y, phi):
            return rk4_step(fso, t, dt, y, phi)

        return step

    def run(self, n_steps: int | None = None, t0: float = 0.0,
            state=None, record=None, jit: bool = True):
        """Run the RK4 loop (one fused lax.scan). Returns ((t, y, phi), recs).

        Compiled programs are cached per (n_steps, record); ``t0`` is a
        traced argument so resumed runs reuse the same executable. Big
        buffers travel as jit arguments (``self.params``).

        Solver-convergence telemetry rides the aux carry
        (:class:`~lpfem.surface.SolveCarry`): after each run,
        ``self.last_solver_stats`` holds the worst per-solve iteration count
        and an ``unconverged`` flag; an unconverged stage also emits a
        ``RuntimeWarning`` — the analogue of MFEM CGSolver's
        "No convergence!" print (``Solvers/laplace_solver.cpp:113`` path),
        which the reference's time loops otherwise silently discard."""
        from .surface import SolveCarry, SolveStats

        if n_steps is None:
            n_steps = self.cfg.nsteps
        y0, phi0 = state if state is not None else self.initial_state(t0)
        t0 = jnp.asarray(t0, dtype=self.dtype)
        # DS outer path: the warm-start carry is a two-f32 pair; the scan
        # carry pytree must be fixed before entry, so convert here (resumed
        # chunks pass the DS pair straight back through `state`)
        from .ds import DS, ds_from_f64
        if self.fso._ds_op is not None and not isinstance(phi0, DS):
            phi0 = ds_from_f64(phi0.astype(jnp.float64))
        aux0 = SolveCarry(phi0, SolveStats.zero())

        if not jit:
            (t, y, aux), outs, ok = rk4_run(self.fso, y0, aux0, t0, self.dt,
                                            n_steps, record=record)
            self._last_ok = ok
            return self._finish(t, y, aux), outs

        # cache key holds a strong reference to `record` (id() alone can be
        # reused after garbage collection and silently return an executable
        # traced with a previous record function)
        key = (n_steps, record)
        if key not in self._compiled:
            from .params import jit_with_params

            def go(t0_, y0_, aux0_):
                return rk4_run(self.fso, y0_, aux0_, t0_, self.dt, n_steps,
                               record=record)

            self._compiled[key] = jit_with_params(go, self.params)
        (t, y, aux), outs, ok = self._compiled[key](t0, y0, aux0)
        self._last_ok = ok
        return self._finish(t, y, aux), outs

    def _finish(self, t, y, aux):
        """Unwrap the telemetry carry; warn once per run on non-convergence."""
        self.last_solver_stats = aux.stats
        if bool(aux.stats.unconverged):
            import warnings
            warnings.warn(
                "Laplace CG did not converge in at least one RK4 stage "
                f"(worst solve used {int(aux.stats.max_iters)} iterations; "
                "threshold not met — raise cg_max_iter / ir_max_outer or "
                "loosen cg_rtol_sq)", RuntimeWarning, stacklevel=3)
        return (t, y, aux.phi)

    def check_state(self, y, phi) -> None:
        """Failure detection (SURVEY.md §5 — the reference has none): raise
        with context if the solver state went non-finite (diverged RK4,
        NaN preconditioner, ...). The in-scan guard (``timestep.rk4_run``)
        freezes the carry at the last finite state; its flag is checked
        here, so a divergence inside a fused multi-step program is reported
        even though the returned state itself stays finite."""
        from .ds import DS, ds_to_f64
        from .profiling import check_finite
        ok = getattr(self, "_last_ok", None)
        if ok is not None and not bool(ok):
            raise FloatingPointError(
                "time integration diverged mid-scan: a non-finite RK4 stage "
                "was detected and the state was frozen at the last finite "
                "step (see timestep.rk4_run guard)")
        check_finite("free-surface state [eta; phi_fs]", y)
        check_finite("volume potential",
                     ds_to_f64(phi) if isinstance(phi, DS) else phi)

    # ----------------------------------------------------------------- errors
    def eta_error_inf(self, y, t, quad: bool = True) -> float:
        """max-norm error of eta vs the analytic wave at time t — the
        dynamic-accuracy metric of
        ``Convergence_and_Scaling/convergence-parallel.cpp:249-281``.
        ``quad=True`` (default) uses MFEM's literal ``ComputeMaxError``
        semantics (max over element integration points,
        :meth:`~lpfem.space.SurfaceSpace.max_error_quad`); ``quad=False``
        is the cheaper nodal max (equal to leading order)."""
        ns = self.surf.n_dofs
        eta = np.asarray(y[:ns])
        w = self.wave
        if quad:
            return self.surf.max_error_quad(
                eta, lambda x, yy, z: w.eta(x, yy, t))
        ex = self.surf.project(lambda x, yy, z: w.eta(x, yy, t))
        return float(np.max(np.abs(eta - ex)))

    def w_error_inf(self, phi, t) -> float:
        from .ds import DS, ds_to_f64
        from .operators import NodalZDerivative
        if isinstance(phi, DS):
            phi = ds_to_f64(phi)
        w_num = np.asarray(NodalZDerivative(self.op_hi or self.op)(phi))
        wv = self.wave
        ex = self.space.project(lambda x, y, z: wv.w_vel(x, y, z, t))
        return float(np.max(np.abs(w_num - ex)))
