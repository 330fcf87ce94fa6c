"""Matrix-free Laplace operator (partial assembly) + full assembly + norms.

JAX replacement for MFEM's ``(Par)BilinearForm + DiffusionIntegrator``
in both assembly modes the reference uses: full sparse assembly
(``Solvers/PF_linear_par.cpp:117-119``) and matrix-free
``AssemblyLevel::PARTIAL`` (``Solvers/PF_linear_par_partial.cpp:118-121``),
plus ``FormLinearSystem``/``RecoverFEMSolution`` essential-dof elimination
(``:155,166``), ``OperatorJacobiSmoother`` diagonal extraction (``:124``),
``ComputeL2Error`` (``Solvers/laplace_solver.cpp:136-138``) and
``GridFunction::GetDerivative`` (``Solvers/PF_linear_serial.cpp:175``).

Apply paths, chosen per mesh by :class:`LaplacePA`:

1. **Separable lattice** (every generated tank): the assembled stiffness is a
   sum of three Kronecker products of banded 1D matrices
   (:class:`SeparableLattice`), applied as seven banded axis contractions.
2. ``mode="fused"`` elsewhere — the gradient-interpolation matrix
   ``Jr [3*q^3, (p+1)^3]`` is materialized once and the element apply
   becomes two matmuls ``[E, L] @ [L, 3Q]`` with L = (p+1)^3.
3. ``mode="sumfact"`` — classic sum-factorized tensor contractions
   (O(p^4) flops/elem), expressed as einsums.

Paths 2 and 3 read the same precomputed geometric factors
``G[e, q, i, j] = w_q |J| J^{-1} J^{-T}`` (the standard PA setup), or their
compact affine form ``C6``.
"""

from __future__ import annotations

from functools import cached_property, partial

import jax
import jax.numpy as jnp
import numpy as np

from .elements import basis_1d
from .mesh import HEX_VERTS
from .space import H1Space

__all__ = ["LaplacePA", "geometric_factors", "nodal_z_derivative"]

# lattice-lex (x fastest) position of each MFEM hex corner
_LEX_OF_VERT = np.array([0, 1, 3, 2, 4, 5, 7, 6])


def _geom_basis(q: int):
    """Order-1 geometry basis at the q quadrature points: (B1 [q,2], D1 [q,2])."""
    b = basis_1d(1, q)
    return b.B, b.D


def _geometry_lattice(space: H1Space):
    """(nodes [ne, (pg+1)^3, 3] in lattice-lex order, pg): the isoparametric
    geometry representation — per-element high-order nodes when the mesh is
    curved (MFEM ``SetCurvature``, ``Solvers/cylinder-diffraction.cpp:264``),
    else the trilinear corner lattice."""
    mesh = space.mesh
    if mesh.geom_nodes is not None:
        return mesh.geom_nodes, mesh.geom_order
    return mesh.corner_coords[:, _LEX_OF_VERT, :], 1


_GEOM_CHUNK = 1 << 16   # elements per host chunk (bounds the [*,Q,3,3] temps)


def _jacobian_chunk(cc, B1, D1, q):
    """Quad-point Jacobians for one element chunk: cc [m, pg1, pg1, pg1, 3]
    -> (J [m, Q, 3, 3], detJ, Jinv). Raises on inverted geometry."""

    def t3(u, Az, Ay, Ax):
        return np.einsum("cz,by,ax,ezyxd->ecbad", Az, Ay, Ax, u,
                         optimize=True)

    dXdx = t3(cc, B1, B1, D1)   # dX/dxi_x at quad pts, [m,q,q,q,3]
    dXdy = t3(cc, B1, D1, B1)
    dXdz = t3(cc, D1, B1, B1)
    J = np.stack([dXdx, dXdy, dXdz], axis=-1)
    m = J.shape[0]
    J = J.reshape(m, q ** 3, 3, 3)
    detJ = np.linalg.det(J)
    if np.any(detJ <= 0):
        raise ValueError("non-positive Jacobian determinant in mesh geometry")
    Jinv = np.linalg.inv(J)     # Jinv[i,j] = dxi_i/dx_j
    return J, detJ, Jinv


def _metric6_chunk(detJ, Jinv):
    """G/w3 at quad points: the 6 unique components of detJ * Jinv Jinv^T,
    order (xx, xy, xz, yy, yz, zz) — [m, Q, 6]."""
    M = np.einsum("eqik,eqjk->eqij", Jinv, Jinv) * detJ[..., None, None]
    return np.stack([M[..., 0, 0], M[..., 0, 1], M[..., 0, 2],
                     M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]], axis=-1)


def affine_c6(space: H1Space, q: int, dtype) -> np.ndarray | None:
    """Streaming affine detection + compact metric, WITHOUT materializing
    the [ne, Q, 6] G: per chunk, test that the quad-point metric is constant
    across the element (the rank-1 ``G = w3 (x) C6`` factorization the apply
    paths exploit) and collect C6 [ne, 6]. Returns None when any element is
    curved/non-affine beyond the dtype-tied tolerance. At the refs=4 bench
    scale (135M dofs) this replaces ~30 GB of host geometry tables with
    100 MB of C6."""
    gnodes, pg = _geometry_lattice(space)
    bg = basis_1d(pg, q)
    B1, D1 = bg.B, bg.D
    pg1 = pg + 1
    cc = gnodes.reshape(-1, pg1, pg1, pg1, 3)
    ne = cc.shape[0]
    C6 = np.empty((ne, 6))
    gmax = 0.0
    rmax = 0.0
    for s in range(0, ne, _GEOM_CHUNK):
        _, detJ, Jinv = _jacobian_chunk(cc[s:s + _GEOM_CHUNK], B1, D1, q)
        M6 = _metric6_chunk(detJ, Jinv)
        C6[s:s + _GEOM_CHUNK] = M6[:, 0, :]
        gmax = max(gmax, float(np.max(np.abs(M6))))
        rmax = max(rmax, float(np.max(np.abs(M6 - M6[:, :1, :]))))
    afftol = 1e-6 if np.dtype(dtype) == np.float32 else 1e-12
    if rmax > afftol * gmax:
        return None
    return C6


def geometric_factors(space: H1Space, q: int | None = None, dtype=jnp.float64):
    """Precompute PA geometric data.

    Returns (G [ne, Q, 6], wdetJ [ne, Q], xq [ne, Q, 3]) with
    Q = q^3 quadrature points per element flattened C-order over (qz, qy, qx).
    Host NumPy in float64, cast to ``dtype`` on return. Supports curved
    (isoparametric) geometry via ``mesh.geom_nodes``. Computed in element
    chunks so the [*, Q, 3, 3] temporaries never exceed ~1 GB.
    """
    p = space.p
    if q is None:
        q = p + 1
    b = basis_1d(p, q)
    qw = b.qwts

    gnodes, pg = _geometry_lattice(space)
    bg = basis_1d(pg, q)
    B1, D1 = bg.B, bg.D
    pg1 = pg + 1
    cc = gnodes.reshape(-1, pg1, pg1, pg1, 3)   # [ne, z, y, x, 3]
    ne = cc.shape[0]
    Q = q ** 3
    w3 = np.einsum("c,b,a->cba", qw, qw, qw).reshape(-1)

    G = np.empty((ne, Q, 6), dtype=dtype)
    wdetJ = np.empty((ne, Q), dtype=dtype)
    for s in range(0, ne, _GEOM_CHUNK):
        _, detJ, Jinv = _jacobian_chunk(cc[s:s + _GEOM_CHUNK], B1, D1, q)
        # G = w |J| Jinv Jinv^T  (contract over physical coordinate index).
        # Stored as the 6 unique symmetric components [ne, Q, 6] in order
        # (xx, xy, xz, yy, yz, zz): the device apply uses elementwise
        # multiply-adds instead of batched 3x3 matvecs (tiny matrix
        # products pad badly and dominate the runtime).
        G[s:s + _GEOM_CHUNK] = w3[None, :, None] * _metric6_chunk(detJ, Jinv)
        wdetJ[s:s + _GEOM_CHUNK] = detJ * w3[None, :]

    # physical quad-point coords (for analytic errors)
    B3 = np.einsum("cz,by,ax->cbazyx", B1, B1, B1).reshape(q ** 3, pg1 ** 3)
    xq = np.einsum("qk,ekd->eqd", B3, gnodes)

    return G, wdetJ, np.asarray(xq, dtype=dtype)


def _grad_interp_matrix(p: int, q: int) -> np.ndarray:
    """Jr [3, q^3, (p+1)^3]: reference-gradient interpolation, C-order (z,y,x)."""
    b = basis_1d(p, q)
    B, D = b.B, b.D
    g_x = np.einsum("cz,by,ax->cbazyx", B, B, D)
    g_y = np.einsum("cz,by,ax->cbazyx", B, D, B)
    g_z = np.einsum("cz,by,ax->cbazyx", D, B, B)
    L = (p + 1) ** 3
    Q = q ** 3
    return np.stack([g.reshape(Q, L) for g in (g_x, g_y, g_z)], axis=0)


def _unfold_last(x: jax.Array, n_e: int, p: int, periodic: bool) -> jax.Array:
    """[..., D] -> [..., n_e, p+1]: overlapping (p+1)-windows at stride p,
    built from one reshape + one strided slice (no gathers)."""
    if periodic:                       # D = n_e * p
        core = x.reshape(*x.shape[:-1], n_e, p)
        nxt = jnp.concatenate([x[..., p::p], x[..., :1]], axis=-1)
    else:                              # D = n_e * p + 1
        core = x[..., :-1].reshape(*x.shape[:-1], n_e, p)
        nxt = x[..., p::p]
    return jnp.concatenate([core, nxt[..., None]], axis=-1)


def _fold_last(u: jax.Array, p: int, periodic: bool) -> jax.Array:
    """Transpose of :func:`_unfold_last`: [..., n_e, p+1] -> [..., D] with
    overlap accumulation via strided adds."""
    n_e = u.shape[-2]
    core = u[..., :p].reshape(*u.shape[:-2], n_e * p)
    nxt = u[..., p]
    if periodic:
        y = core.at[..., p::p].add(nxt[..., :-1])
        return y.at[..., 0].add(nxt[..., -1])
    y = jnp.concatenate([core, jnp.zeros((*core.shape[:-1], 1), core.dtype)],
                        axis=-1)
    return y.at[..., p::p].add(nxt)


class StructuredLattice:
    """Gather-free E-vector transfer on tensor-product (Cartesian) spaces.

    Replaces the irregular E-vector gather/scatter: on the lattice numbering
    (see ``H1Space._try_structured_renumber``), extraction of every
    element's (p+1)^3 dof block is a cascade of per-axis 'unfold' ops
    (reshape + strided slice), and assembly is the transposed 'fold'
    (reshape + strided add). XLA compiles these to dense copies instead of
    index gathers and scatter-adds.
    """

    def __init__(self, struct, p: int):
        self.Dx, self.Dy, self.Dz = struct.dof_dims
        self.nex, self.ney, self.nez = struct.elem_dims
        self.px, self.py, self.pz = struct.periodic
        self.p = p
        self.L = (p + 1) ** 3
        self.ne = self.nex * self.ney * self.nez

    def gather(self, x: jax.Array) -> jax.Array:
        """[n_dofs] -> [ne, (p+1)^3] in mesh element order (lattice-major)."""
        p = self.p
        u = x.reshape(self.Dz, self.Dy, self.Dx)
        u = _unfold_last(u, self.nex, p, self.px)      # [Dz, Dy, nex, p1x]
        u = jnp.moveaxis(u, 1, -1)                      # [Dz, nex, p1x, Dy]
        u = _unfold_last(u, self.ney, p, self.py)      # [Dz, nex, p1x, ney, p1y]
        u = jnp.moveaxis(u, 0, -1)                      # [nex, p1x, ney, p1y, Dz]
        u = _unfold_last(u, self.nez, p, self.pz)      # [nex,p1x,ney,p1y,nez,p1z]
        u = u.transpose(4, 2, 0, 5, 3, 1)               # [nez,ney,nex,p1z,p1y,p1x]
        return u.reshape(self.ne, self.L)

    def scatter(self, ye: jax.Array) -> jax.Array:
        """[ne, (p+1)^3] -> assembled [n_dofs] (transpose of ``gather``)."""
        p1 = self.p + 1
        u = ye.reshape(self.nez, self.ney, self.nex, p1, p1, p1)
        u = u.transpose(2, 5, 1, 4, 0, 3)               # [nex,p1x,ney,p1y,nez,p1z]
        u = _fold_last(u, self.p, self.pz)              # [nex,p1x,ney,p1y,Dz]
        u = jnp.moveaxis(u, -1, 0)                      # [Dz,nex,p1x,ney,p1y]
        u = _fold_last(u, self.p, self.py)              # [Dz,nex,p1x,Dy]
        u = jnp.moveaxis(u, -1, 1)                      # [Dz,Dy,nex,p1x]
        u = _fold_last(u, self.p, self.px)              # [Dz,Dy,Dx]
        return u.reshape(-1)


class ColumnLattice:
    """E-vector transfer on z-extruded meshes (``H1Space.extruded``).

    Dofs are numbered ``node2d * Dz + z``, so extraction is ONE
    ``[ne2d, (p+1)^2]`` gather of contiguous Dz-columns followed by
    reshape/strided-slice z-unfolds (and assembly the transpose with one
    column scatter-add). The irregular index set shrinks from the volume
    (``ne * (p+1)^3``) to the 2D footprint — for imported Gmsh tanks
    without a global lattice (the reference's extruded
    ``mesh_cylinder_half.msh``, ``Solvers/cylinder-diffraction.cpp:225``).
    """

    def __init__(self, ext, p: int):
        self.ed2d = jnp.asarray(ext.ed2d.astype(np.int32))
        self.n2d, self.Dz, self.nz = ext.n2d, ext.Dz, ext.nz
        self.p = p
        self.L2d = ext.ed2d.shape[1]
        self.ne2d = ext.ed2d.shape[0]
        self.ne = self.ne2d * ext.nz

    def gather(self, x: jax.Array) -> jax.Array:
        """[n_dofs] -> [ne, (p+1)^3] in layer-major element order."""
        p, p1 = self.p, self.p + 1
        u = x.reshape(self.n2d, self.Dz)[self.ed2d]     # [ne2d, L2d, Dz]
        u = _unfold_last(u, self.nz, p, False)          # [ne2d, L2d, nz, p1]
        u = u.transpose(2, 0, 3, 1)                     # [nz, ne2d, p1z, L2d]
        return u.reshape(self.ne, p1 * self.L2d)

    def scatter(self, ye: jax.Array) -> jax.Array:
        """[ne, (p+1)^3] -> assembled [n_dofs] (transpose of ``gather``)."""
        p, p1 = self.p, self.p + 1
        u = ye.reshape(self.nz, self.ne2d, p1, self.L2d).transpose(1, 3, 0, 2)
        u = _fold_last(u, p, False)                     # [ne2d, L2d, Dz]
        y = jnp.zeros((self.n2d, self.Dz), dtype=ye.dtype
                      ).at[self.ed2d].add(u)
        return y.reshape(-1)


def _apply_G6(G6: jax.Array, gx: jax.Array, gy: jax.Array, gz: jax.Array) -> jax.Array:
    """h_i = G_ij g_j with symmetric G stored as [..., Q, 6] = (xx,xy,xz,yy,yz,zz).

    Elementwise multiply-adds; returns stacked [..., 3, Q]."""
    hx = G6[..., 0] * gx + G6[..., 1] * gy + G6[..., 2] * gz
    hy = G6[..., 1] * gx + G6[..., 3] * gy + G6[..., 4] * gz
    hz = G6[..., 2] * gx + G6[..., 4] * gy + G6[..., 5] * gz
    return jnp.stack([hx, hy, hz], axis=-2)


def _apply_G6_affine(C6: jax.Array, w3: jax.Array, gx: jax.Array,
                     gy: jax.Array, gz: jax.Array) -> jax.Array:
    """Affine-element metric apply: h_i = w3[q] * C_ij[e] * g_j.

    ``C6 [ne, 6]`` per-element constants, ``w3 [Q]`` quadrature-weight
    products — same math as :func:`_apply_G6` with the rank-1 structure
    exploited (the metric stream shrinks Q-fold)."""
    cx, cxy, cxz = C6[:, 0:1], C6[:, 1:2], C6[:, 2:3]
    cy, cyz, cz = C6[:, 3:4], C6[:, 4:5], C6[:, 5:6]
    hx = (cx * gx + cxy * gy + cxz * gz) * w3
    hy = (cxy * gx + cy * gy + cyz * gz) * w3
    hz = (cxz * gx + cyz * gy + cz * gz) * w3
    return jnp.stack([hx, hy, hz], axis=-2)


def band_1d(hs, basis, periodic: bool, stiff: bool) -> np.ndarray:
    """Assembled 1D stiffness (``stiff``) or mass matrix over elements of
    widths ``hs`` in diagonal-offset band form ``[2p+1, D]`` with
    ``band[p+s, i] = G[i, i+s]`` (zero beyond non-periodic ends). A zero
    width marks an absent element (no contribution): the padded layers of a
    z-slab shard."""
    p = basis.B.shape[1] - 1
    W = basis.qwts
    Khat = (basis.D * W[:, None]).T @ basis.D      # [p1, p1] on [0, 1]
    Mhat = (basis.B * W[:, None]).T @ basis.B
    D = len(hs) * p + (0 if periodic else 1)
    G = np.zeros((D, D))
    for e, he in enumerate(hs):
        if he == 0.0:
            continue
        idx = (e * p + np.arange(p + 1)) % D
        G[np.ix_(idx, idx)] += Khat / he if stiff else Mhat * he
    out = np.zeros((2 * p + 1, D))
    i = np.arange(D)
    for s in range(-p, p + 1):
        if periodic:
            out[p + s] = G[i, (i + s) % D]
        else:
            j = i + s
            ok = (j >= 0) & (j < D)
            out[p + s, ok] = G[i[ok], j[ok]]
    return out


def _band_axis(u, c, axis: int, periodic: bool):
    """Banded 1D contraction along ``axis``: y_i = sum_s c[p+s, i] *
    u_{i+s} (zero / wraparound beyond the ends)."""
    p = (c.shape[0] - 1) // 2
    D = u.shape[axis]
    shape = [1, 1, 1]
    shape[axis] = D
    if periodic:
        terms = [c[p + s].reshape(shape) * jnp.roll(u, -s, axis)
                 for s in range(-p, p + 1)]
    else:
        pad = [(0, 0)] * 3
        pad[axis] = (p, p)
        up = jnp.pad(u, pad)
        terms = [c[k].reshape(shape)
                 * jax.lax.slice_in_dim(up, k, k + D, axis=axis)
                 for k in range(2 * p + 1)]
    return sum(terms)


def sep_apply3(u: jax.Array, bands, px: bool) -> jax.Array:
    """``A u`` on a ``[Dz, Dy, Dx]`` lattice from the six 1D bands
    ``(Kx, Mx, Ky, My, Kz, Mz)``; only x may be periodic."""
    Kx, Mx, Ky, My, Kz, Mz = bands
    t1 = _band_axis(u, Kx, 2, px)
    t2 = _band_axis(u, Mx, 2, px)
    a = _band_axis(t1, My, 1, False) + _band_axis(t2, Ky, 1, False)
    bb = _band_axis(t2, My, 1, False)
    return _band_axis(a, Mz, 0, False) + _band_axis(bb, Kz, 0, False)


class SeparableLattice:
    """Assembled tensor-product (Kronecker) form of the Laplace operator.

    On a tensor-product hex grid whose elements are axis-aligned boxes with
    spacings that depend only on their own axis index (every generated wave
    tank, ``Meshes/wave_tank.cpp``), the assembled stiffness factorizes
    EXACTLY — any quadrature — into

        A  =  Mz (x) My (x) Kx  +  Mz (x) Ky (x) Mx  +  Kz (x) My (x) Mx

    with per-axis assembled 1D stiffness/mass matrices of bandwidth p
    (``K1 = sum_e D^T W D / h_e``, ``M1 = sum_e B^T W B * h_e`` on [0,1]
    reference elements). The apply is then seven banded 1D axis
    contractions over the global dof lattice: ``(p+1)^3 * 3q^3 / (7(2p+1))``
    ≈ 100x fewer flops than the element-local PA form at p=4, zero
    E-vector traffic, and — being shift+FMA streaming, not matmul — exact
    in the working dtype. This is the endpoint of the partial-assembly
    lineage the reference runs through MFEM
    (``Solvers/PF_linear_par_partial.cpp:118-124``); curved or sheared
    lattices take the element paths.
    """

    def __init__(self, bands, dof_dims, periodic, dtype, spacings=None):
        self.Dx, self.Dy, self.Dz = dof_dims
        self.periodic = periodic        # (px, py, pz) — py, pz False
        self.p = (bands[0].shape[0] - 1) // 2
        # per-axis band coefficients [2p+1, D_a], diagonal-offset form:
        # bands[a][p + s, i] = G_a[i, i + s]
        (self.Kx, self.Mx, self.Ky, self.My, self.Kz, self.Mz) = tuple(
            jnp.asarray(b, dtype=dtype) for b in bands)
        # per-axis element spacings (hx, hy, hz) — host NumPy, kept for the
        # per-shard z bands of a z-slab partition (lpfem.shard)
        self.spacings = spacings

    @classmethod
    def build(cls, space, q: int, dtype) -> "SeparableLattice | None":
        """Detect eligibility and assemble the 1D factors (host side);
        returns None when the mesh does not qualify."""
        st = space.struct
        if st is None or st.periodic[1] or st.periodic[2]:
            return None
        from .mesh import HEX_VERTS
        mesh = space.mesh
        if mesh.geom_nodes is not None and mesh.geom_order > 1:
            # isoparametric geometry: the corner lattice can be an
            # axis-aligned box grid while the interior map is curved
            # (e.g. SetCurvature after a projector snap) — the Kronecker
            # factorization only sees corners, so it would silently apply
            # the wrong operator; refuse outright.
            return None
        nex, ney, nez = st.elem_dims
        p = space.p
        if any(d <= 2 * p and per
               for d, per in zip(st.dof_dims, st.periodic)):
            return None              # band offsets would alias mod D
        cc = np.asarray(mesh.corner_coords).reshape(nez, ney, nex, 8, 3)
        lo, hi = cc.min(axis=3), cc.max(axis=3)
        h = hi - lo                                    # [nez, ney, nex, 3]
        hv = np.asarray(HEX_VERTS, dtype=np.float64)   # [8, 3] in {0, 1}
        box = lo[..., None, :] + hv * h[..., None, :]
        scale = np.max(np.abs(cc)) + np.max(h)
        tol = 1e-12 * scale
        if np.max(np.abs(cc - box)) > tol:
            return None              # sheared / curved elements
        # spacings must be separable: h_x(ex), h_y(ey), h_z(ez)
        for a, ax in ((0, (0, 1)), (1, (0, 2)), (2, (1, 2))):
            if np.max(np.ptp(h[..., a], axis=ax)) > tol:
                return None
        hx, hy, hz = h[0, 0, :, 0], h[0, :, 0, 1], h[:, 0, 0, 2]

        b = basis_1d(p, q)
        px = bool(st.periodic[0])
        bands = (band_1d(hx, b, px, True), band_1d(hx, b, px, False),
                 band_1d(hy, b, False, True), band_1d(hy, b, False, False),
                 band_1d(hz, b, False, True), band_1d(hz, b, False, False))
        return cls(bands, st.dof_dims, tuple(bool(x) for x in st.periodic),
                   dtype, spacings=(hx, hy, hz))

    def apply3(self, u: jax.Array) -> jax.Array:
        """A u on the [Dz, Dy, Dx] lattice view."""
        return sep_apply3(u, (self.Kx, self.Mx, self.Ky, self.My, self.Kz,
                              self.Mz), self.periodic[0])

    def apply(self, x: jax.Array) -> jax.Array:
        u = x.reshape(self.Dz, self.Dy, self.Dx)
        return self.apply3(u).reshape(-1)

    def constrained_apply_top(self, x: jax.Array) -> jax.Array:
        """Apply with identity rows/cols on the top z-plane (the free
        surface essential set — same contract as the fused kernel's
        ``ess_top`` mode)."""
        u = x.reshape(self.Dz, self.Dy, self.Dx)
        u0 = u.at[-1].set(0.0)
        y = self.apply3(u0).at[-1].set(u[-1])
        return y.reshape(-1)


def _matmul_precision(name: str | None):
    """Map a precision name to ``jax.lax.Precision`` for the element paths'
    f32 einsums.

    None (the default) and 'highest' give exact f32 products. On the GPU a
    DEFAULT-precision f32 matmul may run on the tensor cores in TF32 (10
    mantissa bits, ~3 decimal digits per product), which caps the accuracy
    an 'f32' operator can deliver — and with it the inner correction of the
    mixed-precision solve. 'default' opts into the backend's choice (TF32),
    'high' asks for the 3-pass bf16 scheme (~f32 products)."""
    if name == "default":
        return jax.lax.Precision.DEFAULT
    return {None: jax.lax.Precision.HIGHEST,
            "high": jax.lax.Precision.HIGH,
            "float32": jax.lax.Precision.HIGHEST,
            "highest": jax.lax.Precision.HIGHEST}[name]


_HI = jax.lax.Precision.HIGHEST


class LaplacePA:
    """Matrix-free Laplace (stiffness) operator on an :class:`H1Space`.

    All heavy state is device arrays; ``apply`` is pure and jit-friendly.
    """

    def __init__(self, space: H1Space, q: int | None = None,
                 dtype=jnp.float64, mode: str = "fused",
                 precision: str | None = None):
        if mode not in ("fused", "sumfact"):
            raise ValueError(f"unknown apply mode {mode!r}")
        p = space.p
        if q is None:
            q = p + 1
        self.space = space
        self.p, self.q = p, q
        self.dtype = dtype
        self.mode = mode
        self.precision = precision
        self._prec = _matmul_precision(precision)
        self.n_dofs = space.n_dofs
        self._elem_dofs = None     # lazy: only the unstructured gather
                                   # fallback reads it (1 GB at refs=4)
        b = basis_1d(p, q)
        self.B = jnp.asarray(b.B, dtype=dtype)
        self.D = jnp.asarray(b.D, dtype=dtype)
        self.Jr = jnp.asarray(_grad_interp_matrix(p, q), dtype=dtype)  # [3,Q,L]
        self.lattice = (StructuredLattice(space.struct, p)
                        if space.struct is not None else None)
        self.column = (ColumnLattice(space.extruded, p)
                       if (self.lattice is None
                           and getattr(space, "extruded", None) is not None)
                       else None)

        # ---- compact affine metric ----
        # For affine (parallelepiped) elements J is constant per element, so
        # G[e,q,ij] = w3[q] * C6[e,ij] with w3 the quadrature-weight products
        # — 6 floats/element instead of 6*Q. The [ne, Q, 6] stream is the
        # single largest HBM read of the element apply (~800MB at 17M dofs);
        # dropping it takes the operator from bandwidth-bound on metrics to
        # bandwidth-bound on the solution vector itself. Detection streams
        # the quad-point metric chunk-wise (affine_c6) so curved meshes fall
        # back automatically and G/wdetJ/xq are never even BUILT for affine
        # operators — they materialize lazily, host-side, on first error-
        # metric / full-assembly access (~30 GB of host tables skipped at
        # the refs=4 / 135M-dof scale).
        self.C6 = None
        self.w3 = None
        self._geom_ready = False
        self._G = self._wdetJ = self._xq = None
        w3 = np.einsum("c,b,a->cba", b.qwts, b.qwts, b.qwts).reshape(-1)
        C = affine_c6(space, q, dtype)
        if C is not None:
            self.C6 = jnp.asarray(np.asarray(C, dtype=dtype))
            self.w3 = jnp.asarray(w3, dtype=dtype)
        else:
            self._materialize_geom(device=True)

        # assembled tensor-product (Kronecker) fast path: exact factorized
        # apply on axis-aligned tensor grids — preferred over the element-
        # local einsum paths wherever the mesh qualifies ("sumfact" keeps
        # its element-local semantics for tests/diagnostics)
        self.sep = (SeparableLattice.build(space, q, dtype)
                    if mode == "fused" else None)
        self._ess_top = False

    # ---- lazy geometry tables (affine operators never build them unless
    # an error metric / full-assembly export asks) ----
    def _materialize_geom(self, device: bool = False) -> None:
        G, wdetJ, xq = geometric_factors(self.space, self.q, self.dtype)
        if device:
            # non-affine: the apply streams G every iteration — device
            G, wdetJ, xq = jnp.asarray(G), jnp.asarray(wdetJ), jnp.asarray(xq)
        self._G, self._wdetJ, self._xq = G, wdetJ, xq
        self._geom_ready = True

    @property
    def elem_dofs(self):
        if self._elem_dofs is None:
            self._elem_dofs = jnp.asarray(
                self.space.elem_dofs.astype(np.int32))
        return self._elem_dofs

    @elem_dofs.setter
    def elem_dofs(self, v):
        self._elem_dofs = v

    @property
    def G(self):
        if not self._geom_ready:
            self._materialize_geom()
        return self._G

    @G.setter
    def G(self, v):          # BigParams threads registered attrs via setattr
        self._G = v

    @property
    def wdetJ(self):
        if not self._geom_ready:
            self._materialize_geom()
        return self._wdetJ

    @wdetJ.setter
    def wdetJ(self, v):
        self._wdetJ = v

    @property
    def xq(self):
        if not self._geom_ready:
            self._materialize_geom()
        return self._xq

    @xq.setter
    def xq(self, v):
        self._xq = v

    def register_params(self, bp, need_diag: bool = True) -> None:
        """Register large device buffers as jit arguments (see
        :mod:`lpfem.params`; avoids embedding them as HLO constants).

        ``need_diag=False`` skips the lazy ``diag`` cached property unless it
        was already computed: the mixed-precision OUTER (f64) operator never
        preconditions, and merely touching ``diag`` here would assemble a
        full f64 E-vector diagonal — at 137M dofs (refs=4) that single
        setup program is what broke the remote compile."""
        bp.register(self, "C6")
        if need_diag or "diag" in self.__dict__:
            bp.register(self, "diag")
        if self.lattice is None and self.column is None:
            # only the unstructured fallback gather/scatter reads it
            bp.register(self, "elem_dofs")
        # with the compact affine metric G/wdetJ/xq are lazy HOST tables
        # (HBM frugality) — don't touch them (that would build them), let
        # alone thread them as per-call jit arguments
        if self.C6 is None:
            bp.register(self, "G", "wdetJ", "xq")
        if self.column is not None:
            bp.register(self.column, "ed2d")

    # ------------------------------------------------------------------ apply
    def gather_E(self, x: jax.Array) -> jax.Array:
        """E-vector gather [n_dofs] -> [ne, L] (structured / extruded-column
        fast paths when available)."""
        if self.lattice is not None:
            return self.lattice.gather(x)
        if self.column is not None:
            return self.column.gather(x)
        return x[self.elem_dofs]

    def apply_local(self, x: jax.Array) -> jax.Array:
        """Element-local apply: gather -> grad -> G -> grad^T. Returns
        per-element contributions [ne, L] (the E-vector form, pre-scatter)."""
        u = self.gather_E(x)                                 # [ne, L]
        if self.mode == "fused":
            # one [E, L] @ [L, 3Q] matmul, elementwise G, transpose
            Jr2 = self.Jr.reshape(3 * self.q ** 3, -1)        # [3Q, L]
            g = jnp.einsum("gl,el->eg", Jr2, u,
                           precision=self._prec)              # [ne, 3Q]
            ne = g.shape[0]
            g = g.reshape(ne, 3, self.q ** 3)
            if self.C6 is not None:
                h = _apply_G6_affine(self.C6, self.w3,
                                     g[:, 0], g[:, 1], g[:, 2])
            else:
                h = _apply_G6(self.G, g[:, 0], g[:, 1], g[:, 2])  # [ne,3,Q]
            return jnp.einsum("gl,eg->el", Jr2, h.reshape(ne, -1),
                              precision=self._prec)
        # sum-factorized path
        p1, q = self.p + 1, self.q
        ne = u.shape[0]
        uz = u.reshape(ne, p1, p1, p1)                        # [e, z, y, x]
        B, D = self.B, self.D

        def t3(v, Az, Ay, Ax):
            return jnp.einsum("cz,by,ax,ezyx->ecba", Az, Ay, Ax, v,
                              precision=self._prec)

        gx = t3(uz, B, B, D).reshape(ne, q ** 3)
        gy = t3(uz, B, D, B).reshape(ne, q ** 3)
        gz = t3(uz, D, B, B).reshape(ne, q ** 3)
        if self.C6 is not None:
            h = _apply_G6_affine(self.C6, self.w3, gx, gy, gz)
        else:
            h = _apply_G6(self.G, gx, gy, gz)
        h = h.reshape(ne, 3, q, q, q)

        def t3t(v, Az, Ay, Ax):
            return jnp.einsum("cz,by,ax,ecba->ezyx", Az, Ay, Ax, v,
                              precision=self._prec)

        y = (t3t(h[:, 0], B, B, D) + t3t(h[:, 1], B, D, B)
             + t3t(h[:, 2], D, B, B))
        return y.reshape(ne, p1 ** 3)

    def apply(self, x: jax.Array) -> jax.Array:
        """y = A x on global dofs."""
        if self.sep is not None:
            return self.sep.apply(x)
        return self.assemble(self.apply_local(x))

    def assemble(self, ye: jax.Array) -> jax.Array:
        """E-vector assembly (structured fold / extruded-column fast paths
        when available, else scatter-add)."""
        if self.lattice is not None:
            return self.lattice.scatter(ye)
        if self.column is not None:
            return self.column.scatter(ye)
        return jnp.zeros(self.n_dofs, dtype=ye.dtype).at[self.elem_dofs].add(ye)

    # --------------------------------------------------------------- diagonal
    @cached_property
    def diag(self) -> jax.Array:
        """Assembled diagonal (MFEM ``OperatorJacobiSmoother`` source,
        ``Solvers/PF_linear_par_partial.cpp:124``)."""
        Jx, Jy, Jz = self.Jr[0], self.Jr[1], self.Jr[2]       # [Q, L]
        if self.C6 is not None:
            # rank-1 metric: d_e = C6 @ W6 with the quadrature sums folded
            # into tiny [6, L] tables — never streams the [ne, Q, 6] G
            # (host-resident in the affine case)
            W6 = jnp.stack([
                jnp.einsum("q,ql,ql->l", self.w3, Jx, Jx, precision=_HI),
                2 * jnp.einsum("q,ql,ql->l", self.w3, Jx, Jy, precision=_HI),
                2 * jnp.einsum("q,ql,ql->l", self.w3, Jx, Jz, precision=_HI),
                jnp.einsum("q,ql,ql->l", self.w3, Jy, Jy, precision=_HI),
                2 * jnp.einsum("q,ql,ql->l", self.w3, Jy, Jz, precision=_HI),
                jnp.einsum("q,ql,ql->l", self.w3, Jz, Jz, precision=_HI)])
            return self.assemble(jnp.dot(self.C6, W6, precision=_HI))
        G = self.G

        def gq(k, J2):
            return jnp.einsum("eq,ql->el", G[..., k], J2, precision=_HI)

        d_e = (gq(0, Jx * Jx) + 2 * gq(1, Jx * Jy) + 2 * gq(2, Jx * Jz)
               + gq(3, Jy * Jy) + 2 * gq(4, Jy * Jz) + gq(5, Jz * Jz))
        return self.assemble(d_e)

    # ---------------------------------------------------- essential-dof forms
    def enable_top_plane_ess(self, ess_dofs) -> bool:
        """Enable the fused essential-dof constraint when ``ess_dofs`` is
        exactly the top z-plane of a separable lattice (the free surface —
        true for every tank problem). ``constrained_apply`` then drops the
        plane inside the banded apply instead of masking the whole vector
        twice; the caller promises to always pass the same essential set."""
        st = self.space.struct
        if self.sep is None or st is None:
            return False
        Dx, Dy, Dz = st.dof_dims
        top = Dx * Dy * (Dz - 1) + np.arange(Dx * Dy)
        match = bool(np.array_equal(np.sort(np.asarray(ess_dofs)), top))
        if self._ess_top and not match:
            # a previous caller enabled the fused constraint for the top
            # plane; honoring a different essential set through the latched
            # path would silently apply the WRONG constraint
            raise ValueError("in-kernel essential constraint already enabled "
                             "for the top plane; got a different ess set")
        self._ess_top = match
        return self._ess_top

    def constrained_apply(self, x: jax.Array, ess: jax.Array) -> jax.Array:
        """Apply with identity rows/cols on essential dofs (the operator
        ``FormLinearSystem`` produces)."""
        if self._ess_top:
            return self.sep.constrained_apply_top(x)
        x0 = x.at[ess].set(0.0)
        y = self.apply(x0)
        return y.at[ess].set(x[ess])

    def constrained_rhs(self, b: jax.Array, ess: jax.Array,
                        ess_vals: jax.Array) -> tuple[jax.Array, jax.Array]:
        """(B, X0): eliminated RHS and initial guess for the constrained
        system — ``B = b - A x_bc`` on free dofs, ``x_bc`` on essential ones."""
        x_bc = jnp.zeros(self.n_dofs, dtype=b.dtype).at[ess].set(ess_vals)
        B = b - self.apply(x_bc)
        B = B.at[ess].set(ess_vals)
        return B, x_bc

    # ------------------------------------------------------------------ norms
    def interp_quad(self, x: jax.Array) -> jax.Array:
        """Field values at quadrature points, [ne, Q]."""
        p1, q = self.p + 1, self.q
        u = self.gather_E(x).reshape(-1, p1, p1, p1)
        v = jnp.einsum("cz,by,ax,ezyx->ecba", self.B, self.B, self.B, u,
                       precision=_HI)
        return v.reshape(u.shape[0], q ** 3)

    def l2_norm_sq(self, x: jax.Array) -> jax.Array:
        v = self.interp_quad(x)
        return jnp.sum(self.wdetJ * v * v)

    def l2_error(self, x: jax.Array, exact_fn) -> jax.Array:
        """L2 error against ``exact_fn(xq, yq, zq)`` evaluated at quad points
        (MFEM ``ComputeL2Error`` semantics)."""
        v = self.interp_quad(x)
        ex = exact_fn(self.xq[..., 0], self.xq[..., 1], self.xq[..., 2])
        d = v - ex
        return jnp.sqrt(jnp.sum(self.wdetJ * d * d))

    # ------------------------------------------------------------ full assembly
    def element_matrices(self) -> jax.Array:
        """Dense element stiffness matrices [ne, L, L] (full-assembly path,
        MFEM ``BilinearForm::Assemble`` default,
        ``Solvers/PF_linear_par.cpp:117-119``)."""
        idx = ((0, 1, 2), (1, 3, 4), (2, 4, 5))
        if self.C6 is not None:
            # rank-1 metric: A_e = sum_ij C6full[e,i,j] * K[i,j] with the
            # quadrature folded into tiny [3, 3, L, L] tables (G stays host)
            K = jnp.einsum("q,iqk,jql->ijkl", self.w3, self.Jr, self.Jr,
                           precision=_HI)
            C6f = jnp.stack(
                [jnp.stack([self.C6[:, idx[i][j]] for j in range(3)],
                           axis=-1) for i in range(3)], axis=-2)  # [ne,3,3]
            return jnp.einsum("eij,ijkl->ekl", C6f, K, precision=_HI)
        G6 = self.G
        Gfull = jnp.stack(
            [jnp.stack([G6[..., idx[i][j]] for j in range(3)], axis=-1)
             for i in range(3)], axis=-2)
        return jnp.einsum("iqk,eqij,jql->ekl", self.Jr, Gfull, self.Jr,
                          precision=_HI)

    def assemble_scipy(self):
        """Assembled sparse matrix (host, SciPy CSR) for validation."""
        import scipy.sparse as sp
        Ae = np.asarray(self.element_matrices())
        ed = self.space.elem_dofs
        L = ed.shape[1]
        rows = np.repeat(ed, L, axis=1).ravel()
        cols = np.tile(ed, (1, L)).ravel()
        A = sp.coo_matrix((Ae.ravel(), (rows, cols)),
                          shape=(self.n_dofs, self.n_dofs))
        return A.tocsr()


class NodalZDerivative:
    """w = d(phi)/dz projected onto the H1 nodes with shared-node averaging —
    the semantics of MFEM ``GridFunction::GetDerivative(1, 2, w)``
    (``Solvers/PF_linear_serial.cpp:175``): per-element nodal derivative,
    arithmetically averaged over the elements sharing each node.

    Geometry tables (inverse-Jacobian z-column at every element node) are
    precomputed on host once; ``__call__`` is pure/jit-friendly.
    """

    def __init__(self, op: LaplacePA):
        space = op.space
        p = space.p
        p1 = p + 1
        b = basis_1d(p)
        self.p1 = p1
        self.op = op
        self.Dn = jnp.asarray(b.Dn, dtype=op.dtype)
        self.Bn = jnp.asarray(np.eye(p1), dtype=op.dtype)

        # Jacobian at the element nodes from the (possibly curved) geometry
        from .elements import lagrange_eval
        gnodes, pg = _geometry_lattice(space)
        B1n, D1n = lagrange_eval(basis_1d(pg).nodes, b.nodes)
        pg1 = pg + 1
        cc = gnodes.reshape(-1, pg1, pg1, pg1, 3)

        def t3g(u, Az, Ay, Ax):
            return np.einsum("cz,by,ax,ezyxd->ecbad", Az, Ay, Ax, u, optimize=True)

        ne = cc.shape[0]
        J = np.stack([t3g(cc, B1n, B1n, D1n), t3g(cc, B1n, D1n, B1n),
                      t3g(cc, D1n, B1n, B1n)], axis=-1).reshape(ne, p1 ** 3, 3, 3)
        Jinv = np.linalg.inv(J)
        # only the z-column is needed: grad_z = sum_i Jinv[i, 2] * ghat_i
        Jz = Jinv[..., 2]                                          # [ne, L, 3]
        # affine elements have a constant Jacobian: compact the metric to 3
        # floats/element — at 17M dofs the [ne, L, 3] stream is ~3 GB per
        # z-derivative, the largest HBM read of the RK4 stage after the
        # solve itself (same trade as LaplacePA.C6)
        ztol = 1e-6 if np.dtype(op.dtype) == np.float32 else 1e-12
        self.Jz3 = None
        self.Jinv_z = None
        if np.max(np.abs(Jz - Jz[:, :1, :])) <= ztol * np.max(np.abs(Jz)):
            self.Jz3 = jnp.asarray(Jz[:, 0, :], dtype=op.dtype)   # [ne, 3]
        else:
            # only materialized on device when actually needed — at the
            # 17M-dof scale the full [ne, L, 3] stream is hundreds of MB
            self.Jinv_z = jnp.asarray(Jz, dtype=op.dtype)         # [ne, L, 3]
        # inv_mult stays host-side until needed: armed top-trace runs never
        # read it on device, and it is [n_dofs] in the zderiv dtype (1 GB of
        # f64 at refs=4). enable_top_trace materializes it when the fast
        # path does NOT engage; direct __call__ users fall back on demand.
        self._inv_mult_np = np.asarray(1.0 / space.node_mult,
                                       dtype=np.dtype(op.dtype))
        self.inv_mult = None
        self._Jz_np = Jz[:, 0, :] if self.Jz3 is not None else None
        self._top = None

    def enable_top_trace(self, ess: np.ndarray) -> bool:
        """Precompute the free-surface trace fast path (used by
        :class:`~lpfem.surface.FreeSurfaceOperator`): on z-extruded geometry
        — inverse-Jacobian z-column exactly ``(0, 0, jz)`` with one ``jz``
        across the top element layer — the top-plane nodal derivative is
        element-independent, so the trace needs only the top ``p+1`` dof
        planes: ``w(x, y) = jz * sum_m Dn[p, m] * phi[z = Dz-1-p+m, y, x]``
        (no E-vector round trip; ~nez-fold less HBM traffic than the full
        volume derivative whose trace MFEM's ``GetDerivative`` +
        ``GetSubVector`` takes, ``Solvers/PF_linear_serial.cpp:175,268``).

        ``ess`` are the volume dof indices of the surface nodes, in surface
        order. Returns True (and arms :meth:`top_trace`) when the geometry
        and dof layout qualify; False leaves the full path in use (and
        materializes the device ``inv_mult`` the full path multiplies by).
        """
        armed = self._detect_top(ess)
        if not armed and self.inv_mult is None:
            self.inv_mult = jnp.asarray(self._inv_mult_np)
        return armed

    def _detect_top(self, ess: np.ndarray) -> bool:
        sp = self.op.space
        Jz = self._Jz_np
        if Jz is None:
            return False
        scale = np.max(np.abs(Jz[:, 2]))
        if scale == 0.0 or np.max(np.abs(Jz[:, :2])) > 1e-13 * scale:
            return False
        ess = np.asarray(ess)
        st = getattr(sp, "struct", None)
        ext = getattr(sp, "extruded", None)
        if st is not None:
            Dx, Dy, Dz = st.dof_dims
            if st.periodic[2]:
                return False
            jz_top = Jz[-st.elem_dims[0] * st.elem_dims[1]:, 2]
            off = (Dz - 1) * Dy * Dx
            if np.any(ess < off):
                return False
            idx, nplane = ess - off, Dy * Dx
        elif ext is not None:
            Dz = ext.Dz
            jz_top = Jz[-ext.ed2d.shape[0]:, 2]
            if np.any(ess % Dz != Dz - 1):
                return False
            idx, nplane = ess // Dz, ext.n2d
        else:
            return False
        if np.max(jz_top) - np.min(jz_top) > 1e-13 * scale:
            return False
        self._top = (float(jz_top[0]), "struct" if st is not None else "ext",
                     int(Dz), int(nplane))
        self.top_idx = jnp.asarray(idx.astype(np.int32))
        return True

    def top_trace(self, x: jax.Array) -> jax.Array:
        """Free-surface trace of the nodal z-derivative (requires a prior
        successful :meth:`enable_top_trace`); identical values to
        ``self(x)[ess]`` — the dropped in-plane metric terms are exact zeros
        and the shared-node average collapses (k equal contributions / k)."""
        jz, layout, Dz, nplane = self._top
        p1 = self.p1
        dn = self.Dn[p1 - 1]
        from .ds import DS
        if isinstance(x, DS):
            # double-single volume potential (the mixed DS solve carry):
            # only the top p+1 planes are needed, so recombining to the
            # zderiv dtype costs O(p * nplane) — never a full-volume f64 op
            dt = self.Dn.dtype
            if layout == "struct":
                sl = lambda v: v.reshape(Dz, nplane)[Dz - p1:]
            else:
                sl = lambda v: v.reshape(nplane, Dz)[:, Dz - p1:]
            xs = sl(x.hi).astype(dt) + sl(x.lo).astype(dt)
        elif layout == "struct":
            xs = x.reshape(Dz, nplane)[Dz - p1:]
        else:
            xs = x.reshape(nplane, Dz)[:, Dz - p1:]
        w = jz * (jnp.dot(dn, xs, precision=_HI) if layout == "struct"
                  else jnp.dot(xs, dn, precision=_HI))
        return w[self.top_idx]

    def register_params(self, bp) -> None:
        bp.register(self, "Jinv_z", "Jz3", "inv_mult")
        if self._top is not None:
            bp.register(self, "top_idx")
        # gather tables only — a derivative never needs the Laplace diagonal
        # (in mixed mode self.op is the f64 outer operator; forcing its lazy
        # diag here would assemble a huge unused f64 E-vector program)
        self.op.register_params(bp, need_diag=False)

    def __call__(self, x: jax.Array) -> jax.Array:
        op = self.op
        p1 = self.p1
        u = op.gather_E(x).reshape(-1, p1, p1, p1)
        ne = u.shape[0]
        Bn, Dn = self.Bn, self.Dn

        def t3(v, Az, Ay, Ax):
            return jnp.einsum("cz,by,ax,ezyx->ecba", Az, Ay, Ax, v,
                              precision=_HI)

        gx = t3(u, Bn, Bn, Dn).reshape(ne, p1 ** 3)
        gy = t3(u, Bn, Dn, Bn).reshape(ne, p1 ** 3)
        gz = t3(u, Dn, Bn, Bn).reshape(ne, p1 ** 3)
        if self.Jz3 is not None:
            Jz = self.Jz3
            w_e = Jz[:, 0:1] * gx + Jz[:, 1:2] * gy + Jz[:, 2:3] * gz
        else:
            ghat = jnp.stack([gx, gy, gz], axis=-1)               # [ne, L, 3]
            w_e = jnp.einsum("eli,eli->el", self.Jinv_z, ghat,
                             precision=_HI)

        im = (self.inv_mult if self.inv_mult is not None
              else jnp.asarray(self._inv_mult_np))   # on-demand (metrics)
        return op.assemble(w_e) * im


class AssembledLaplace:
    """Fully assembled sparse Laplace operator on device (ELL format).

    The full-assembly mode of the reference (``BilinearForm::Assemble`` +
    hypre ParCSR SpMV, ``Solvers/PF_linear_par.cpp:114-120``). Rows are
    padded to the max nnz; the apply is one gather + row-sum. The matrix-free
    PA path reads far fewer bytes (no matrix, no gathers on the structured
    lattice) — this exists for capability parity, for
    unstructured meshes where assembled SpMV can win at low order, and as
    the reference operator in tests.
    """

    def __init__(self, pa: LaplacePA):
        import scipy.sparse as sp
        A = pa.assemble_scipy().tocsr()
        A.sum_duplicates()
        n = A.shape[0]
        nnz_row = np.diff(A.indptr)
        k = int(nnz_row.max())
        cols = np.zeros((n, k), dtype=np.int32)
        vals = np.zeros((n, k))
        for i in range(n):
            s, e = A.indptr[i], A.indptr[i + 1]
            cols[i, : e - s] = A.indices[s:e]
            vals[i, : e - s] = A.data[s:e]
        self.n_dofs = n
        self.row_nnz_max = k
        self.cols = jnp.asarray(cols)
        self.vals = jnp.asarray(vals, dtype=pa.dtype)
        self.diag = jnp.asarray(A.diagonal(), dtype=pa.dtype)
        self._csr = A

    def apply(self, x: jax.Array) -> jax.Array:
        return jnp.sum(self.vals * x[self.cols], axis=1)

    def constrained_apply(self, x: jax.Array, ess: jax.Array) -> jax.Array:
        x0 = x.at[ess].set(0.0)
        y = self.apply(x0)
        return y.at[ess].set(x[ess])

    def constrained_rhs(self, b: jax.Array, ess: jax.Array,
                        ess_vals: jax.Array) -> tuple[jax.Array, jax.Array]:
        """Same contract as :meth:`LaplacePA.constrained_rhs` — the operator
        is a drop-in CG operator for the time loop (``apply_mode="assembled"``,
        the ``PF_linear_par`` configuration)."""
        x_bc = jnp.zeros(self.n_dofs, dtype=b.dtype).at[ess].set(ess_vals)
        B = b - self.apply(x_bc)
        B = B.at[ess].set(ess_vals)
        return B, x_bc

    def register_params(self, bp) -> None:
        bp.register(self, "cols", "vals", "diag")

    def gauss_seidel_host(self, b: np.ndarray, x0: np.ndarray,
                          sweeps: int = 1) -> np.ndarray:
        """Symmetric Gauss-Seidel sweeps on host (SciPy triangular solves) —
        the semantics of MFEM's serial ``GSSmoother``
        (``Solvers/laplace_solver.cpp:112``). Inherently sequential, hence a
        host-side validation/serial-parity path; the device-side
        preconditioners of equal role are Chebyshev-Jacobi and p-multigrid
        (:mod:`lpfem.multigrid`)."""
        import scipy.sparse as sp
        from scipy.sparse.linalg import spsolve_triangular
        A = self._csr
        L = sp.tril(A, format="csr")
        U = sp.triu(A, format="csr")
        D = A.diagonal()
        x = x0.copy()
        for _ in range(sweeps):
            x = spsolve_triangular(L, b - U @ x + D * x, lower=True)
            x = spsolve_triangular(U, b - L @ x + D * x, lower=False)
        return x


def nodal_z_derivative(op: LaplacePA, x: jax.Array) -> jax.Array:
    """One-shot convenience wrapper around :class:`NodalZDerivative`."""
    return NodalZDerivative(op)(x)


def _nodal_geom_basis(p: int):
    from .elements import lagrange_eval
    b = basis_1d(p)
    nodes1 = np.array([0.0, 1.0])
    return lagrange_eval(nodes1, b.nodes)
