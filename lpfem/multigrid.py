"""p-multigrid preconditioner with Chebyshev-Jacobi smoothing.

Replacement for the reference's strong preconditioner,
``HypreBoomerAMG`` + CG (``Solvers/laplace_solver_parallel.cpp:134-146``).
Algebraic multigrid setup is host-sequential and pointer-chasing. The
equivalent for spectral elements that stays on the device is
**p-coarsening**: the same mesh discretized at decreasing order
(p -> p/2 -> ... -> 1), embedded-interpolation transfers, Chebyshev(degree-k)
Jacobi smoothing on every level (pure operator applies), and a dense
inverse (or Chebyshev) coarse solve.

Every f32 contraction here states ``Precision.HIGHEST``: on the GPU a
default-precision f32 matmul may run in TF32, and the transfers and the
dense coarse solve are part of the preconditioner the inner CG trusts. Iteration counts stay
O(1) in both h and p, matching BoomerAMG-CG's role at the 10M-DOF scale
(SURVEY.md §7 step 7).

Everything is jit-compatible: the V-cycle is a fixed unrolled recursion over
a static level list; eigenvalue estimates are computed once at setup.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .elements import basis_1d, lagrange_eval
from .operators import LaplacePA
from .space import H1Space

__all__ = ["ChebyshevSmoother", "PMultigrid", "estimate_lmax"]

_HI = jax.lax.Precision.HIGHEST


def estimate_lmax(apply_fn, inv_diag, n: int, iters: int = 20,
                  dtype=jnp.float64, safety: float = 1.1,
                  params=None) -> float:
    """Power-iteration estimate of lambda_max(D^-1 A) (MFEM's
    ``OperatorChebyshevSmoother`` does the same with 10 power iterations).

    ``params`` (a :class:`lpfem.params.BigParams`) threads the operator's
    large buffers as jit arguments instead of HLO constants."""
    key = jax.random.PRNGKey(0)
    v = jax.random.normal(key, (n,), dtype=dtype)

    def it(v, invd):
        w = invd * apply_fn(v)
        lam = jnp.linalg.norm(w)
        return w / lam, lam

    if params is not None:
        from .params import jit_with_params
        itj = jit_with_params(it, params)
    else:
        itj = jax.jit(it)

    lam = 1.0
    for _ in range(iters):
        v, lam = itj(v, inv_diag)
    return float(lam) * safety


class ChebyshevSmoother:
    """Fixed-degree Chebyshev acceleration of Jacobi: z ~= A^-1 r.

    A *linear, symmetric positive* operation (a fixed polynomial in D^-1 A),
    hence valid both as a CG preconditioner and as an MG smoother. Classic
    three-term recurrence on [lmax/30, lmax] (hypre's default window).
    """

    def __init__(self, apply_fn, inv_diag, lmax: float, degree: int = 3,
                 lmin_frac: float = 1.0 / 30.0):
        self.apply_fn = apply_fn
        self.inv_diag = inv_diag
        self.degree = degree
        lmin = lmin_frac * lmax
        self.theta = (lmax + lmin) / 2.0
        self.delta = (lmax - lmin) / 2.0

    def __call__(self, r, z0=None):
        """Return z ~= A^-1 r (z0 optional initial guess, used by MG)."""
        A, invD = self.apply_fn, self.inv_diag
        theta, delta = self.theta, self.delta
        if z0 is None:
            res = r
            z = jnp.zeros_like(r)
        else:
            z = z0
            res = r - A(z)
        sigma = theta / delta
        rho = 1.0 / sigma
        d = invD * res / theta
        z = z + d
        for _ in range(self.degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * (invD * (r - A(z)))
            z = z + d
            rho = rho_new
        return z


def _interp_1d(p_coarse: int, p_fine: int) -> np.ndarray:
    """[pf+1, pc+1] interpolation from coarse GLL nodes to fine GLL nodes."""
    Bc, _ = lagrange_eval(basis_1d(p_coarse).nodes, basis_1d(p_fine).nodes)
    return Bc


def _axis_interp(n: int, pc: int, pf: int, periodic: bool) -> np.ndarray:
    """Grid-level 1D interpolation matrix [Df, Dc] from the order-``pc``
    GLL grid to the order-``pf`` GLL grid over ``n`` elements. Banded
    (each fine node depends on one element's pc+1 coarse nodes); shared
    boundary-node rows coincide between neighboring elements."""
    I1 = _interp_1d(pc, pf)
    Dc = n * pc + (0 if periodic else 1)
    Df = n * pf + (0 if periodic else 1)
    P = np.zeros((Df, Dc))
    for e in range(n):
        rows = (e * pf + np.arange(pf + 1)) % Df
        cols = (e * pc + np.arange(pc + 1)) % Dc
        P[np.ix_(rows, cols)] = I1
    return P


class _Transfer:
    """Embedded-interpolation transfer between two consecutive levels.

    Two realizations of the same operator P (and its exact transpose):

    - **Lattice fast path** (``P1s`` set): on structured-lattice dof
      numbering the grid-level prolongation is the tensor product
      ``Pz x Py x Px`` of banded 1D matrices, applied as three dense
      per-axis contractions over the whole lattice, with no E-vector
      round-trips through the compact [ne, L] gather/assemble.
    - **Element path** (fallback): ``via`` supplies the fine-side
      gather/assemble and nodal multiplicity. For p-coarsening on one
      mesh, ``via`` is the fine level itself. For h-coarsening below p=1
      on structured meshes, ``via`` is a helper p=2 space on the half
      mesh — on the structured lattice its global dof numbering is
      IDENTICAL to the fine p=1 space's (midpoints of a uniform
      refinement are exactly the p=2 GLL nodes), so its fold/unfold
      realize the fine side of the transfer directly.

    Both compute identical operators: grid-level,
    ``P = M_f^{-1} A_f I3 G_c`` collapses to pure interpolation (duplicate
    element contributions at shared nodes are equal), and the element
    restrict ``A_c I3^T G_f M_f^{-1}`` is exactly ``P^T``.
    """

    def __init__(self, I3, via_gather, via_assemble, via_inv_mult,
                 P1s=None, fine_shape=None, coarse_shape=None):
        self.I3 = I3
        self.via_gather = via_gather
        self.via_assemble = via_assemble
        self.via_inv_mult = via_inv_mult
        self.P1z = self.P1y = self.P1x = None
        if P1s is not None:
            self.P1z, self.P1y, self.P1x = P1s
        self.fine_shape = fine_shape
        self.coarse_shape = coarse_shape

    def prolong(self, coarse: "_Level", fine: "_Level", xc):
        if self.P1x is not None:
            v = xc.reshape(self.coarse_shape)
            v = jnp.einsum("ZC,Cyx->Zyx", self.P1z, v, precision=_HI)
            v = jnp.einsum("YC,zCx->zYx", self.P1y, v, precision=_HI)
            v = jnp.einsum("XC,zyC->zyX", self.P1x, v, precision=_HI)
            return v.reshape(-1) * fine.free
        uc = coarse.op.gather_E(xc)
        uf = jnp.einsum("fc,ec->ef", self.I3, uc, precision=_HI)
        xf = self.via_assemble(uf) * self.via_inv_mult
        return xf * fine.free

    def restrict(self, coarse: "_Level", fine: "_Level", rf):
        if self.P1x is not None:
            v = rf.reshape(self.fine_shape)
            v = jnp.einsum("ZC,Zyx->Cyx", self.P1z, v, precision=_HI)
            v = jnp.einsum("YC,zYx->zCx", self.P1y, v, precision=_HI)
            v = jnp.einsum("XC,zyX->zyC", self.P1x, v, precision=_HI)
            return v.reshape(-1) * coarse.free
        uf = self.via_gather(rf * self.via_inv_mult)
        uc = jnp.einsum("fc,ef->ec", self.I3, uf, precision=_HI)
        rc = coarse.op.assemble(uc)
        return rc * coarse.free


def _coarsen_structured_mesh(space: H1Space):
    """Merge 2x2x2 element blocks of a structured (lattice-ordered) mesh.

    Returns the coarse :class:`~lpfem.mesh.Mesh` (no boundary table — the
    preconditioner levels derive essential dofs from the lattice), or None
    if any element dimension is odd.
    """
    from .mesh import Mesh, HEX_VERTS
    st = space.struct
    nex, ney, nez = st.elem_dims
    if nex % 2 or ney % 2 or nez % 2:
        return None
    # a periodic axis below 3 coarse elements has multiply-adjacent faces,
    # which the p>=2 'via' space's topological numbering cannot represent
    if any(st.periodic[a] and st.elem_dims[a] // 2 < 3 for a in range(3)):
        return None
    mesh = space.mesh
    elems = mesh.elems.reshape(nez, ney, nex, 8)
    cc = mesh.corner_coords.reshape(nez, ney, nex, 8, 3)
    cE = np.zeros((nez // 2, ney // 2, nex // 2, 8), dtype=np.int64)
    cC = np.zeros((nez // 2, ney // 2, nex // 2, 8, 3))
    for v, (vx, vy, vz) in enumerate(HEX_VERTS):
        cE[..., v] = elems[vz::2, vy::2, vx::2, v][: nez // 2, : ney // 2, : nex // 2]
        cC[..., v, :] = cc[vz::2, vy::2, vx::2, v, :][: nez // 2, : ney // 2, : nex // 2]
    cE = cE.reshape(-1, 8)
    used = np.unique(cE)
    remap = np.full(mesh.n_verts, -1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    return Mesh(verts=mesh.verts[used], elems=remap[cE],
                corner_coords=cC.reshape(-1, 8, 3),
                bdr_quads=np.zeros((0, 4), dtype=np.int64),
                bdr_attrs=np.zeros(0, dtype=np.int64),
                periodic=mesh.periodic, periodic_axes=mesh.periodic_axes)


def _top_plane_dofs(struct) -> np.ndarray:
    """Lattice dofs on the z-max plane (the tank free surface, attr 2)."""
    Dx, Dy, Dz = struct.dof_dims
    return (Dx * Dy * (Dz - 1) + np.arange(Dx * Dy)).astype(np.int64)


class _Level:
    def __init__(self, op: LaplacePA, ess: np.ndarray):
        self.op = op
        self.ess = jnp.asarray(ess.astype(np.int32))
        if hasattr(op, "enable_top_plane_ess"):
            op.enable_top_plane_ess(ess)   # in-kernel constraint fast path
        n = op.n_dofs
        free = np.ones(n)
        free[ess] = 0.0
        self.free = jnp.asarray(free, dtype=op.dtype)
        diag_c = op.diag.at[self.ess].set(1.0)
        self.inv_diag = 1.0 / diag_c
        self.inv_mult = jnp.asarray(1.0 / op.space.node_mult, dtype=op.dtype)

    def apply_c(self, x):
        if getattr(self.op, "_ess_top", False):
            return self.op.constrained_apply(x, self.ess)
        y = self.op.apply(x * self.free)
        return y * self.free + x * (1.0 - self.free)

    def register_params(self, bp) -> None:
        self.op.register_params(bp)
        bp.register(self, "free", "inv_diag", "inv_mult")


class PMultigrid:
    """V-cycle p-multigrid preconditioner for the essential-dof-constrained
    Laplace operator.

    ``precond(r)`` assumes ``r`` vanishes on essential dofs (true inside CG on
    the constrained system) and returns an SPD-consistent approximation to
    ``A_c^{-1} r``.
    """

    def __init__(self, fine_op: LaplacePA, ess_attr: int = 2,
                 levels: list[int] | None = None, smooth_degree: int = 3,
                 coarse_dense_limit: int = 6000, coarse_cheb_degree: int = 16,
                 h_coarsen_min_dofs: int = 20000,
                 ess_dofs: np.ndarray | None = None):
        space = fine_op.space
        mesh = space.mesh
        p = space.p
        if levels is None:
            levels = []
            q = p
            while q > 1:
                levels.append(q)
                q = max(1, q // 2)
            levels.append(1)
        assert levels[0] == p
        self.orders = levels

        self.levels: list[_Level] = []
        for li, pl in enumerate(levels):
            if li == 0:
                op = fine_op
                sp = space
                ess = (np.asarray(ess_dofs) if ess_dofs is not None
                       else sp.boundary_dofs(ess_attr))
            else:
                sp = H1Space(mesh, pl)
                op = LaplacePA(sp, dtype=fine_op.dtype, mode=fine_op.mode,
                               precision=fine_op.precision)
                ess = sp.boundary_dofs(ess_attr)
            self.levels.append(_Level(op, ess))

        # transfers: per-level-pair embedded interpolation matrices [Lf, Lc]
        def _I3(pc, pf):
            I1 = _interp_1d(pc, pf)
            I3 = np.einsum("cz,by,ax->cbazyx", I1, I1, I1).reshape(
                (pf + 1) ** 3, (pc + 1) ** 3)
            return jnp.asarray(I3, dtype=fine_op.dtype)

        self.transfers: list[_Transfer] = []
        for li in range(len(levels) - 1):
            fl = self.levels[li]
            stf = fl.op.space.struct
            stc = self.levels[li + 1].op.space.struct
            P1s = fshape = cshape = None
            if stf is not None and stc is not None:
                pc, pf = levels[li + 1], levels[li]
                dims, per = stf.elem_dims, stf.periodic
                P1s = tuple(jnp.asarray(
                    _axis_interp(dims[a], pc, pf, per[a]),
                    dtype=fine_op.dtype) for a in (2, 1, 0))
                fshape = tuple(reversed(stf.dof_dims))
                cshape = tuple(reversed(stc.dof_dims))
            self.transfers.append(_Transfer(
                _I3(levels[li + 1], levels[li]),
                fl.op.gather_E, fl.op.assemble, fl.inv_mult,
                P1s=P1s, fine_shape=fshape, coarse_shape=cshape))

        # ---- h-coarsening below p=1 (structured tank meshes) ----
        # On the lattice numbering, p=1 on a uniformly refined Cartesian mesh
        # shares its dof grid with p=2 on the half mesh; continue the
        # hierarchy by mesh halving until the coarse problem is dense-solver
        # sized. Restores h-independent iteration counts at 10M+ dofs where
        # a fixed-degree Chebyshev coarse solve degrades.
        while True:
            bot = self.levels[-1]
            sp_b = bot.op.space
            # stop well above the dense limit: a Chebyshev coarse solve at a
            # few 10k dofs is already h-independent enough, and very deep
            # chains reach degenerate (single-element-axis) meshes
            if (sp_b.p != 1 or sp_b.struct is None
                    or bot.op.n_dofs <= max(coarse_dense_limit,
                                            h_coarsen_min_dofs)):
                break
            # only when the essential set is exactly the free-surface plane
            if not np.array_equal(np.sort(np.asarray(bot.ess)),
                                  _top_plane_dofs(sp_b.struct)):
                break
            mesh_c = _coarsen_structured_mesh(sp_b)
            if mesh_c is None:
                break
            sp_c = H1Space(mesh_c, 1)
            hs = H1Space(mesh_c, 2)
            if (sp_c.struct is None or hs.struct is None
                    or hs.struct.dof_dims != sp_b.struct.dof_dims
                    or hs.n_dofs != bot.op.n_dofs):
                break
            op_c = LaplacePA(sp_c, dtype=fine_op.dtype, mode=fine_op.mode,
                             precision=fine_op.precision)
            lvl_c = _Level(op_c, _top_plane_dofs(sp_c.struct))
            from .operators import StructuredLattice
            lat = StructuredLattice(hs.struct, 2)
            hs_inv_mult = jnp.asarray(1.0 / hs.node_mult, dtype=fine_op.dtype)
            dims_c, per_c = sp_c.struct.elem_dims, sp_c.struct.periodic
            P1s = tuple(jnp.asarray(_axis_interp(dims_c[a], 1, 2, per_c[a]),
                                    dtype=fine_op.dtype) for a in (2, 1, 0))
            self.transfers.append(_Transfer(
                _I3(1, 2), lat.gather, lat.scatter, hs_inv_mult, P1s=P1s,
                fine_shape=tuple(reversed(sp_b.struct.dof_dims)),
                coarse_shape=tuple(reversed(sp_c.struct.dof_dims))))
            self.levels.append(lvl_c)
            self.orders = self.orders + [1]

        # smoothers (need lmax of D^-1 A_c per level); thread each level's
        # big buffers as jit arguments (lpfem.params)
        from .params import BigParams
        self.smoothers = []
        for lv in self.levels:
            bp = BigParams()
            lv.register_params(bp)
            lmax = estimate_lmax(lv.apply_c, lv.inv_diag, lv.op.n_dofs,
                                 dtype=fine_op.dtype, params=bp)
            self.smoothers.append(ChebyshevSmoother(
                lv.apply_c, lv.inv_diag, lmax, degree=smooth_degree))

        # coarse solver
        cl = self.levels[-1]
        nC = cl.op.n_dofs
        if nC <= coarse_dense_limit:
            A = cl.op.assemble_scipy().toarray()
            ess = np.asarray(cl.ess)
            A[ess, :] = 0.0
            A[:, ess] = 0.0
            A[ess, ess] = 1.0
            # factor once on host (f64 for stability), apply on device
            self._coarse_inv = jnp.asarray(np.linalg.inv(A), dtype=fine_op.dtype)
            self.coarse_solve = lambda r: jnp.dot(self._coarse_inv, r,
                                                  precision=_HI)
        else:
            bp = BigParams()
            cl.register_params(bp)
            lmax = estimate_lmax(cl.apply_c, cl.inv_diag, nC,
                                 dtype=fine_op.dtype, params=bp)
            cheb = ChebyshevSmoother(cl.apply_c, cl.inv_diag, lmax,
                                     degree=coarse_cheb_degree)
            self.coarse_solve = lambda r: cheb(r)

    # ------------------------------------------------------------ transfers
    def prolong(self, li: int, xc):
        """coarse level li+1 -> fine level li."""
        return self.transfers[li].prolong(self.levels[li + 1],
                                          self.levels[li], xc)

    def restrict(self, li: int, rf):
        """fine level li -> coarse level li+1 (transpose of prolong)."""
        return self.transfers[li].restrict(self.levels[li + 1],
                                           self.levels[li], rf)

    # -------------------------------------------------------------- V-cycle
    def _vcycle(self, li: int, r):
        if li == len(self.levels) - 1:
            return self.coarse_solve(r)
        sm = self.smoothers[li]
        lv = self.levels[li]
        z = sm(r)                                   # pre-smooth from zero
        rc = self.restrict(li, r - lv.apply_c(z))
        zc = self._vcycle(li + 1, rc)
        z = z + self.prolong(li, zc)
        z = sm(r, z0=z)                             # post-smooth
        return z

    def __call__(self, r):
        return self._vcycle(0, r)

    def register_params(self, bp) -> None:
        for lv in self.levels:
            lv.register_params(bp)
        for sm in self.smoothers:
            bp.register(sm, "inv_diag")
        for tr in self.transfers:
            bp.register(tr, "via_inv_mult", "P1z", "P1y", "P1x")
        bp.register(self, "_coarse_inv")
