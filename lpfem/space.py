"""H1 finite-element spaces: global dof numbering, boundary dofs, surface trace.

Replacement for MFEM's ``(Par)FiniteElementSpace`` +
``GetEssentialTrueDofs`` + ``SubMesh::CreateFromBoundary``/``Transfer``
(reference: ``Solvers/PF_linear_par_partial.cpp:276-285``,
``Solvers/PF_linear_serial.cpp:287-294``).

Numbering is *topological* (vertex / edge / face / interior dofs with
orientation canonicalization), computed once on host with vectorized NumPy.
This handles periodic meshes for free — ``MakePeriodic`` identifies vertices,
so seam dofs unify without any special casing (MFEM needs the L-dof/T-dof
distinction for this; here T == the single global numbering).

The device-side consumers are plain integer gather/scatter tables:
``elem_dofs [n_elem, (p+1)^3]`` (the E-vector map) and
``surf_to_vol [n_surf_dofs]`` (the SubMesh transfer map).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

from .elements import basis_1d
from .mesh import HEX_EDGES, HEX_FACES, HEX_VERTS, Mesh

__all__ = ["H1Space", "SurfaceSpace", "build_hex_dofs", "build_quad_dofs"]

QUAD_VERTS = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.int64)
QUAD_EDGES = np.array([[0, 1], [1, 2], [2, 3], [3, 0]], dtype=np.int64)


def _canonical_uv(r, s, p, k, fwd):
    """Map face-interior lattice coords (r, s) to the canonical frame.

    The canonical frame is anchored at the face corner with the smallest
    global vertex id, first axis toward its smaller-id neighbor. Both elements
    adjacent to a face agree on it, so face dofs are shared consistently
    regardless of local orientation (the analogue of MFEM's face-orientation
    DofTransformation machinery, but for tensor-product H1 it is a pure
    index permutation).

    k:   [n] argmin position of the corner cycle (0..3)
    fwd: [n] bool, True if the forward cycle neighbor has the smaller id
    """
    u_f = np.choose(k, [np.full_like(k, r), np.full_like(k, s),
                        np.full_like(k, p - r), np.full_like(k, p - s)])
    v_f = np.choose(k, [np.full_like(k, s), np.full_like(k, p - r),
                        np.full_like(k, p - s), np.full_like(k, r)])
    u = np.where(fwd, u_f, v_f)
    v = np.where(fwd, v_f, u_f)
    return u, v


def build_hex_dofs(elems: np.ndarray, n_verts: int, p: int):
    """Global H1 dof numbering on a conforming hex mesh.

    Returns ``(elem_dofs [ne, (p+1)^3] int64 in lattice-lex order (x fastest),
    n_dofs, face_info)`` where ``face_info = (uniq_faces, face_id [ne, 6])``
    for boundary lookups.
    """
    ne = elems.shape[0]
    p1 = p + 1

    def lat(ix, iy, iz):
        return ix + p1 * (iy + p1 * iz)

    # unique faces (always needed, for boundary lookup)
    f_quads = elems[:, HEX_FACES]                          # [ne, 6, 4]
    uniq_f, inv_f = np.unique(np.sort(f_quads, axis=2).reshape(-1, 4),
                              axis=0, return_inverse=True)
    face_id = inv_f.reshape(ne, 6)
    nF = len(uniq_f)

    # A face shared by more than two element-face slots, or twice by the
    # same element, makes the vertex-keyed topological numbering merge
    # distinct dofs (at p >= 2) — e.g. a periodic axis with fewer than 3
    # elements, which MFEM's MakePeriodic forbids for the same reason.
    fcount = np.bincount(inv_f, minlength=nF)
    fsort = np.sort(face_id, axis=1)
    if p >= 2 and (fcount.max() > 2
                   or np.any(fsort[:, 1:] == fsort[:, :-1])):
        raise ValueError(
            "mesh has multiply-adjacent faces (e.g. a periodic axis with "
            "fewer than 3 elements); H1 dof numbering would merge distinct "
            "dofs at p >= 2")

    # native C++ fast path for large meshes (identical sharing semantics,
    # ids permuted — see lpfem/native)
    if ne * p1 ** 3 > 2_000_000:
        from . import native
        res = native.build_hex_dofs(elems, n_verts, p)
        if res is not None:
            return res[0], res[1], (uniq_f, face_id)

    elem_dofs = np.zeros((ne, p1 ** 3), dtype=np.int64)
    for v, (vx, vy, vz) in enumerate(HEX_VERTS):
        elem_dofs[:, lat(vx * p, vy * p, vz * p)] = elems[:, v]

    n_dofs = n_verts
    if p >= 2:
        e_pairs = elems[:, HEX_EDGES]                      # [ne, 12, 2]
        uniq_e, inv_e = np.unique(np.sort(e_pairs, axis=2).reshape(-1, 2),
                                  axis=0, return_inverse=True)
        edge_id = inv_e.reshape(ne, 12)
        flip_e = e_pairs[:, :, 0] > e_pairs[:, :, 1]
        nE = len(uniq_e)

        for ei, (a, b) in enumerate(HEX_EDGES):
            c0 = HEX_VERTS[a] * p
            d = HEX_VERTS[b] - HEX_VERTS[a]
            base = n_verts + edge_id[:, ei] * (p - 1)
            for m in range(1, p):
                node = c0 + m * d
                mm = np.where(flip_e[:, ei], p - m, m)
                elem_dofs[:, lat(*node)] = base + (mm - 1)

        base_f = n_verts + nE * (p - 1)
        ar = np.arange(ne)
        for fi in range(6):
            corners = HEX_FACES[fi]
            ids = f_quads[:, fi, :]
            k = np.argmin(ids, axis=1)
            fwd = ids[ar, (k + 1) % 4] < ids[ar, (k - 1) % 4]
            c0 = HEX_VERTS[corners[0]] * p
            e1 = HEX_VERTS[corners[1]] - HEX_VERTS[corners[0]]
            e2 = HEX_VERTS[corners[3]] - HEX_VERTS[corners[0]]
            fbase = base_f + face_id[:, fi] * (p - 1) ** 2
            for s in range(1, p):
                for r in range(1, p):
                    node = c0 + r * e1 + s * e2
                    u, v = _canonical_uv(r, s, p, k, fwd)
                    elem_dofs[:, lat(*node)] = fbase + (u - 1) + (p - 1) * (v - 1)

        base_i = base_f + nF * (p - 1) ** 2
        ibase = base_i + ar * (p - 1) ** 3
        idx = 0
        for iz in range(1, p):
            for iy in range(1, p):
                for ix in range(1, p):
                    elem_dofs[:, lat(ix, iy, iz)] = ibase + idx
                    idx += 1
        n_dofs = base_i + ne * (p - 1) ** 3

    return elem_dofs, n_dofs, (uniq_f, face_id)


def build_quad_dofs(quads: np.ndarray, n_verts: int, p: int):
    """Global H1 dof numbering on a conforming quad (2D) mesh.

    Same scheme as :func:`build_hex_dofs`, one dimension down. Local node
    ordering is lattice-lex (r fastest): ``n = r + (p+1)*s`` with corners
    (0,0)->v0, (p,0)->v1, (p,p)->v2, (0,p)->v3.
    """
    nq = quads.shape[0]
    p1 = p + 1

    def lat(r, s):
        return r + p1 * s

    elem_dofs = np.zeros((nq, p1 ** 2), dtype=np.int64)
    for v, (vx, vy) in enumerate(QUAD_VERTS):
        elem_dofs[:, lat(vx * p, vy * p)] = quads[:, v]

    n_dofs = n_verts
    if p >= 2:
        e_pairs = quads[:, QUAD_EDGES]                     # [nq, 4, 2]
        uniq_e, inv_e = np.unique(np.sort(e_pairs, axis=2).reshape(-1, 2),
                                  axis=0, return_inverse=True)
        edge_id = inv_e.reshape(nq, 4)
        flip_e = e_pairs[:, :, 0] > e_pairs[:, :, 1]
        nE = len(uniq_e)
        for ei, (a, b) in enumerate(QUAD_EDGES):
            c0 = QUAD_VERTS[a] * p
            d = QUAD_VERTS[b] - QUAD_VERTS[a]
            base = n_verts + edge_id[:, ei] * (p - 1)
            for m in range(1, p):
                node = c0 + m * d
                mm = np.where(flip_e[:, ei], p - m, m)
                elem_dofs[:, lat(*node)] = base + (mm - 1)
        base_i = n_verts + nE * (p - 1)
        ibase = base_i + np.arange(nq) * (p - 1) ** 2
        idx = 0
        for s in range(1, p):
            for r in range(1, p):
                elem_dofs[:, lat(r, s)] = ibase + idx
                idx += 1
        n_dofs = base_i + nq * (p - 1) ** 2
    return elem_dofs, n_dofs


def _geom_weights(p: int) -> np.ndarray:
    """Trilinear geometry weights at the (p+1)^3 GLL lattice: [(p+1)^3, 8]."""
    gll = basis_1d(p).nodes
    p1 = p + 1
    W = np.zeros((p1 ** 3, 8))
    for iz in range(p1):
        for iy in range(p1):
            for ix in range(p1):
                n = ix + p1 * (iy + p1 * iz)
                xi = np.array([gll[ix], gll[iy], gll[iz]])
                for v, (vx, vy, vz) in enumerate(HEX_VERTS):
                    W[n, v] = ((xi[0] if vx else 1 - xi[0])
                               * (xi[1] if vy else 1 - xi[1])
                               * (xi[2] if vz else 1 - xi[2]))
    return W


@dataclass(frozen=True)
class ExtrudedInfo:
    """z-extrusion structure of an (otherwise unstructured) mesh.

    When present, dofs are numbered ``node2d * Dz + z`` (z fastest) on
    vertical columns over a 2D quad mesh, and elements are ordered
    layer-major. The E-vector transfer then needs only a [ne2d, (p+1)^2]
    gather of contiguous Dz-columns plus reshape z-unfolds — the irregular
    part of the apply shrinks from the volume to the 2D footprint. This is
    the fast path for imported Gmsh tanks (e.g. the reference's extruded
    ``mesh_cylinder_half.msh``, ``Solvers/cylinder-diffraction.cpp:225``)."""
    ed2d: np.ndarray     # [ne2d, (p+1)^2] 2D dof map
    n2d: int             # 2D dof count
    Dz: int              # p*nz + 1 dof levels
    nz: int              # element layers


@dataclass(frozen=True)
class StructuredInfo:
    """Tensor-product lattice structure of a Cartesian mesh/space.

    When present, dofs are numbered ``ix + Dx*(iy + Dy*iz)`` on the global
    GLL lattice and elements are ordered ``ex + nex*(ey + ney*ez)``. The
    matrix-free apply then performs E-vector gather/scatter as pure
    reshape/strided-slice 'unfold/fold' ops — no irregular gathers, the
    dominant cost of an unstructured apply (SURVEY.md §7 'hard parts': unstructured
    gather/scatter)."""
    dof_dims: tuple      # (Dx, Dy, Dz)
    elem_dims: tuple     # (nex, ney, nez)
    periodic: tuple      # (px, py, pz) bools


def _detect_structured_mesh(mesh: Mesh):
    """(elem_dims, elem_perm) if the mesh is a Cartesian tensor product."""
    cen = mesh.corner_coords.mean(axis=1)
    dims, idx = [], []
    for a in range(3):
        r = np.round(cen[:, a], 9)
        u = np.unique(r)
        dims.append(len(u))
        idx.append(np.searchsorted(u, r))
    if dims[0] * dims[1] * dims[2] != mesh.n_elems:
        return None
    lin = idx[0] + dims[0] * (idx[1] + dims[1] * idx[2])
    if len(np.unique(lin)) != mesh.n_elems:
        return None
    return tuple(dims), np.argsort(lin, kind="stable")


class H1Space:
    """H1 Lagrange space of order ``p`` on a hex :class:`Mesh`.

    On Cartesian (tensor-product) meshes the elements are reordered
    lattice-major and the dofs renumbered onto the global GLL lattice
    (``self.struct`` is then a :class:`StructuredInfo`); this enables the
    gather-free structured apply in :mod:`lpfem.operators`. Unstructured
    (e.g. Gmsh) meshes keep the generic topological numbering.
    """

    def __init__(self, mesh: Mesh, p: int, structured: bool = True):
        self.struct = None
        self.extruded = None
        det = None
        lattice = structured and mesh.elem_lattice is not None
        if lattice:
            # generator-declared logical lattice (curved tensor-product
            # meshes, e.g. the polar cylinder block): reorder lattice-major
            nex, ney, nez = mesh.lattice_dims
            el = np.asarray(mesh.elem_lattice)
            eperm = np.argsort(el[:, 0] + nex * (el[:, 1] + ney * el[:, 2]),
                               kind="stable")
        else:
            det = _detect_structured_mesh(mesh) if structured else None
            if det is not None:
                elem_dims, eperm = det
        if lattice or det is not None:
            mesh = Mesh(mesh.verts, mesh.elems[eperm],
                        mesh.corner_coords[eperm], mesh.bdr_quads,
                        mesh.bdr_attrs, mesh.periodic,
                        None if mesh.geom_nodes is None else mesh.geom_nodes[eperm],
                        mesh.geom_order, periodic_axes=mesh.periodic_axes,
                        elem_lattice=(mesh.elem_lattice[eperm] if lattice else None),
                        lattice_dims=mesh.lattice_dims)
        self.mesh = mesh
        self.p = p
        self.elem_dofs, self.n_dofs, (self._uniq_faces, self._face_id) = \
            build_hex_dofs(mesh.elems, mesh.n_verts, p)
        if lattice:
            self._renumber_from_lattice()
        elif det is not None:
            self._try_structured_renumber(elem_dims)
        if self.struct is None and structured:
            self._try_extruded_renumber()

        # boundary face -> (element, local face) lookup
        if len(mesh.bdr_quads):
            bkeys = np.sort(mesh.bdr_quads, axis=1)
            dt = np.dtype([("", bkeys.dtype)] * 4)
            tab = np.ascontiguousarray(self._uniq_faces).view(dt).ravel()
            q = np.ascontiguousarray(bkeys).view(dt).ravel()
            fidx = np.searchsorted(tab, q)
            ok = tab[np.clip(fidx, 0, len(tab) - 1)] == q
            if not np.all(ok):
                raise ValueError("boundary face not found in element faces")
            # invert face_id -> (elem, local face): first adjacency wins
            owner_e = np.full(len(self._uniq_faces), -1, dtype=np.int64)
            owner_f = np.full(len(self._uniq_faces), -1, dtype=np.int64)
            ne = mesh.n_elems
            flat = self._face_id.ravel()
            order = np.arange(len(flat))[::-1]
            owner_e[flat[order]] = order // 6
            owner_f[flat[order]] = order % 6
            self.bdr_elem = owner_e[fidx]
            self.bdr_face = owner_f[fidx]
        else:
            self.bdr_elem = np.zeros(0, dtype=np.int64)
            self.bdr_face = np.zeros(0, dtype=np.int64)

    # -------------------------------------------------- structured renumber
    def _renumber_from_lattice(self) -> None:
        """Renumber dofs onto the global GLL lattice of a generator-declared
        logical element lattice (``mesh.elem_lattice``/``lattice_dims``).

        Unlike :meth:`_try_structured_renumber` this is purely integer —
        no coordinate tensor-product detection — so it works for curved
        meshes whose *topology* is a deformed box (polar cylinder block).
        The candidate numbering is verified against the topological
        ``build_hex_dofs`` sharing pattern over EVERY element (each old dof
        id must map to exactly one lattice id, bijectively); on any mismatch
        (e.g. inconsistent element orientation) we silently keep the
        unstructured numbering.
        """
        mesh = self.mesh
        nex, ney, nez = mesh.lattice_dims
        p, p1 = self.p, self.p + 1
        per = tuple(a in mesh.periodic_axes for a in range(3))
        Dx = nex * p + (0 if per[0] else 1)
        Dy = ney * p + (0 if per[1] else 1)
        Dz = nez * p + (0 if per[2] else 1)
        if Dx * Dy * Dz != self.n_dofs:
            return
        el = np.asarray(mesh.elem_lattice)
        ax = np.arange(p1)
        gx = el[:, 0, None] * p + ax
        gy = el[:, 1, None] * p + ax
        gz = el[:, 2, None] * p + ax
        if per[0]:
            gx %= Dx
        if per[1]:
            gy %= Dy
        if per[2]:
            gz %= Dz
        # local lex order (x fastest) matching build_hex_dofs
        new = (gx[:, None, None, :] + Dx * (gy[:, None, :, None]
                                            + Dy * gz[:, :, None, None]))
        new = new.reshape(len(el), p1 ** 3)
        m = np.full(self.n_dofs, -1, dtype=np.int64)
        m[self.elem_dofs.ravel()] = new.ravel()
        if not np.array_equal(m[self.elem_dofs], new):
            return  # sharing pattern disagrees: orientation not lattice-aligned
        if m.min() < 0 or len(np.unique(m)) != self.n_dofs:
            return
        self.elem_dofs = new
        self.struct = StructuredInfo(dof_dims=(Dx, Dy, Dz),
                                     elem_dims=(nex, ney, nez), periodic=per)
        self.__dict__.pop("node_coords", None)
        self.__dict__.pop("node_mult", None)

    def _try_extruded_renumber(self) -> None:
        """Renumber dofs onto vertical columns of a z-extruded mesh.

        Detects meshes built as a 2D quad mesh swept in z (the structure of
        every wave tank, including unstructured Gmsh imports like the
        reference's ``mesh_cylinder_half.msh``): element corners sit on two
        consecutive z-levels, vertices stack in vertical columns, and every
        layer repeats the same 2D footprint with the same orientation. On
        success dofs are renumbered ``node2d * Dz + z`` (z fastest, so each
        column is a contiguous slab), elements are reordered layer-major,
        and ``self.extruded`` is set — enabling the column E-vector fast
        path in :mod:`lpfem.operators`. The candidate numbering is verified
        against the topological ``build_hex_dofs`` sharing pattern over
        every element (bijective remap); on any mismatch the unstructured
        numbering is silently kept.
        """
        mesh = self.mesh
        ne = mesh.n_elems
        p, p1 = self.p, self.p + 1
        cz = np.round(mesh.corner_coords[:, :, 2], 9)      # [ne, 8]
        levels = np.unique(cz)
        nz = len(levels) - 1
        if nz < 1 or ne % nz != 0:
            return
        lev = np.searchsorted(levels, cz)
        # HEX_VERTS convention: corners 0..3 on the bottom face, 4..7 above
        bot, top = lev[:, :4], lev[:, 4:]
        if not (np.all(bot == bot[:, :1]) and np.all(top == bot[:, :1] + 1)):
            return
        layer = bot[:, 0]
        if np.any(np.bincount(layer, minlength=nz) != ne // nz):
            return

        elems = mesh.elems
        nv = mesh.n_verts
        vz = np.round(mesh.verts[:, 2], 9)
        vpos = np.searchsorted(levels, vz)
        if not np.all(levels[np.clip(vpos, 0, nz)] == vz):
            return
        base = np.where(vpos == 0)[0]
        n2d_v = len(base)
        if n2d_v * (nz + 1) != nv:
            return
        # vertical vertex columns: propagate 2D ids level by level through
        # each element's (bottom corner i) -> (top corner i+4) pairs
        vert2d = np.full(nv, -1, dtype=np.int64)
        vert2d[base] = np.arange(n2d_v)
        for k in range(nz):
            es = np.where(layer == k)[0]
            src = elems[es, :4].ravel()
            dst = elems[es, 4:].ravel()
            new = vert2d[src]
            if np.any(new < 0):
                return
            cur = vert2d[dst]
            if np.any((cur >= 0) & (cur != new)):
                return
            vert2d[dst] = new
        if np.any(vert2d < 0):
            return

        # 2D footprint from the layer-0 elements (their orientation); every
        # element must repeat its column's footprint with the SAME corner
        # order, else local dof lattices would disagree between layers
        e0 = np.where(layer == 0)[0]
        quads2d = vert2d[elems[e0][:, :4]]                 # [ne2d, 4]
        ne2d = len(e0)
        keys = np.sort(quads2d, axis=1)
        dt4 = np.dtype([("", keys.dtype)] * 4)
        tab = np.ascontiguousarray(keys).view(dt4).ravel()
        order0 = np.argsort(tab)
        all_q = vert2d[elems[:, :4]]
        qk = np.ascontiguousarray(np.sort(all_q, axis=1)).view(dt4).ravel()
        pos = np.searchsorted(tab[order0], qk)
        if np.any(pos >= ne2d) or not np.all(tab[order0][pos] == qk):
            return
        col_of = order0[pos]                               # [ne]
        if not np.array_equal(quads2d[col_of], all_q):
            return                                         # rotated layer

        ed2d, n2d = build_quad_dofs(quads2d, n2d_v, p)
        Dz = p * nz + 1
        if n2d * Dz != self.n_dofs:
            return
        # candidate numbering: dof = node2d * Dz + (p*layer + lz), local
        # order lz major then the 2D lattice (s, r) — hex lattice-lex
        lz = np.arange(p1)
        zs = (p * layer)[:, None, None] + lz[None, :, None]   # [ne, p1, 1]
        new = (ed2d[col_of][:, None, :] * Dz + zs).reshape(ne, p1 ** 3)
        m = np.full(self.n_dofs, -1, dtype=np.int64)
        m[self.elem_dofs.ravel()] = new.ravel()
        if not np.array_equal(m[self.elem_dofs], new):
            return
        if m.min() < 0 or len(np.unique(m)) != self.n_dofs:
            return

        # commit: layer-major element order (matches the column gather)
        eperm = np.argsort(layer * ne2d + col_of, kind="stable")
        self.mesh = Mesh(
            mesh.verts, mesh.elems[eperm], mesh.corner_coords[eperm],
            mesh.bdr_quads, mesh.bdr_attrs, mesh.periodic,
            None if mesh.geom_nodes is None else mesh.geom_nodes[eperm],
            mesh.geom_order, periodic_axes=mesh.periodic_axes)
        self.elem_dofs = new[eperm]
        self._face_id = self._face_id[eperm]
        self.extruded = ExtrudedInfo(ed2d=ed2d, n2d=n2d, Dz=Dz, nz=nz)
        self.__dict__.pop("node_coords", None)
        self.__dict__.pop("node_mult", None)

    def _try_structured_renumber(self, elem_dims) -> None:
        """Renumber dofs onto the global GLL lattice if the node coordinates
        form a tensor product; sets ``self.struct`` on success."""
        mesh = self.mesh
        X = np.zeros((self.n_dofs, 3))
        flat = self.elem_dofs.ravel()[::-1]
        X[flat] = self.elem_node_coords.reshape(-1, 3)[::-1]
        bbmin, bbmax = mesh.bounding_box()
        per = tuple(a in mesh.periodic_axes for a in range(3))
        dims, idx = [], []
        for a in range(3):
            r = np.round(X[:, a], 9)
            if per[a]:
                hi = np.round(bbmax[a], 9)
                r = np.where(r == hi, np.round(bbmin[a], 9), r)
            u = np.unique(r)
            pos = np.searchsorted(u, r)
            if not np.all(u[pos] == r):
                return
            dims.append(len(u))
            idx.append(pos)
        Dx, Dy, Dz = dims
        if Dx * Dy * Dz != self.n_dofs:
            return
        new = idx[0] + Dx * (idx[1] + Dy * idx[2])
        if len(np.unique(new)) != self.n_dofs:
            return
        # sanity: every element's local dof order must be the x-fastest
        # lattice order with unit strides from its own origin (wrapping on
        # periodic axes). A Cartesian mesh imported with rotated element
        # connectivity can have lattice centroids but non-lattice local
        # axes — fall back to the unstructured numbering like every other
        # detection bail-out (the gather-free StructuredLattice transfer
        # requires this exact order).
        p1 = self.p + 1
        ix = np.arange(p1)
        for a, axis in ((0, 3), (1, 2), (2, 1)):
            g = idx[a][self.elem_dofs].reshape(-1, p1, p1, p1)
            base = np.take(g, [0], axis=axis)
            shape = [1, 1, 1, 1]
            shape[axis] = p1
            want = base + ix.reshape(shape)
            if per[a]:
                want = want % dims[a]
            if not np.array_equal(g, want):
                return
        self.elem_dofs = new[self.elem_dofs]
        self.struct = StructuredInfo(dof_dims=(Dx, Dy, Dz),
                                     elem_dims=tuple(elem_dims),
                                     periodic=per)
        # invalidate caches that depend on dof numbering
        self.__dict__.pop("node_coords", None)
        self.__dict__.pop("node_mult", None)

    # ------------------------------------------------------------- geometry
    @cached_property
    def elem_node_coords(self) -> np.ndarray:
        """[ne, (p+1)^3, 3] physical coordinates of every element lattice node
        (curved geometry honored when ``mesh.geom_nodes`` is set)."""
        if self.mesh.geom_nodes is not None:
            from .elements import basis_1d, lagrange_eval
            pg = self.mesh.geom_order
            Bg, _ = lagrange_eval(basis_1d(pg).nodes, basis_1d(self.p).nodes)
            B3 = np.einsum("cz,by,ax->cbazyx", Bg, Bg, Bg).reshape(
                (self.p + 1) ** 3, (pg + 1) ** 3)
            return np.einsum("lk,ekd->eld", B3, self.mesh.geom_nodes)
        W = _geom_weights(self.p)
        return np.einsum("lk,ekd->eld", W, self.mesh.corner_coords)

    @cached_property
    def node_coords(self) -> np.ndarray:
        """[n_dofs, 3] representative physical coordinates per dof.

        For periodic meshes, seam dofs take one of their (equivalent modulo
        the period) positions — fine for projecting periodic fields, which is
        the only use (MFEM has the same representative-coordinate behavior
        through its L-dof geometry).
        """
        X = np.zeros((self.n_dofs, 3))
        flat = self.elem_dofs.ravel()[::-1]
        X[flat] = self.elem_node_coords.reshape(-1, 3)[::-1]
        return X

    @cached_property
    def node_mult(self) -> np.ndarray:
        """[n_dofs] number of elements sharing each dof (for nodal averaging,
        the MFEM ``GridFunction::GetDerivative`` semantics,
        ``Solvers/PF_linear_serial.cpp:175``)."""
        return np.bincount(self.elem_dofs.ravel(), minlength=self.n_dofs).astype(np.float64)

    # ------------------------------------------------------------ boundaries
    def boundary_faces(self, attrs) -> np.ndarray:
        attrs = np.atleast_1d(np.asarray(attrs))
        return np.where(np.isin(self.mesh.bdr_attrs, attrs))[0]

    def face_lattice_dofs(self, belem: np.ndarray, bface: np.ndarray) -> np.ndarray:
        """[nb, (p+1)^2] volume dofs of each boundary face, in the face's
        2D lattice order (r fastest, corners c0..c3 = HEX_FACES cycle)."""
        p, p1 = self.p, self.p + 1
        out = np.zeros((len(belem), p1 ** 2), dtype=np.int64)
        for fi in range(6):
            sel = np.where(bface == fi)[0]
            if not len(sel):
                continue
            corners = HEX_FACES[fi]
            c0 = HEX_VERTS[corners[0]] * p
            e1 = HEX_VERTS[corners[1]] - HEX_VERTS[corners[0]]
            e2 = HEX_VERTS[corners[3]] - HEX_VERTS[corners[0]]
            cols = np.zeros(p1 ** 2, dtype=np.int64)
            for s in range(p1):
                for r in range(p1):
                    node = c0 + r * e1 + s * e2
                    cols[r + p1 * s] = node[0] + p1 * (node[1] + p1 * node[2])
            out[sel] = self.elem_dofs[np.ix_(belem[sel], cols)]
        return out

    def boundary_dofs(self, attrs) -> np.ndarray:
        """Unique dofs on boundary faces with the given attributes — the
        essential-true-dof list (MFEM ``GetEssentialTrueDofs``,
        ``Solvers/PF_linear_par_partial.cpp:407-412``)."""
        bsel = self.boundary_faces(attrs)
        if not len(bsel):
            return np.zeros(0, dtype=np.int64)
        fd = self.face_lattice_dofs(self.bdr_elem[bsel], self.bdr_face[bsel])
        return np.unique(fd)

    def project(self, fn) -> np.ndarray:
        """Nodal interpolation of ``fn(x, y, z)`` (MFEM ``ProjectCoefficient``)."""
        X = self.node_coords
        return np.asarray(fn(X[:, 0], X[:, 1], X[:, 2]), dtype=np.float64)


class SurfaceSpace:
    """Trace space on boundary faces with a given attribute.

    The counterpart of MFEM's ``SubMesh::CreateFromBoundary`` +
    bidirectional ``SubMesh::Transfer`` (``Solvers/PF_linear_serial.cpp:290``):
    a standalone 2D H1 numbering over the boundary quads plus a single
    gather/scatter index map ``surf_to_vol``.
    """

    def __init__(self, vol: H1Space, attr: int = 2):
        self.vol = vol
        self.p = vol.p
        p, p1 = vol.p, vol.p + 1
        bsel = vol.boundary_faces(attr)
        if not len(bsel):
            raise ValueError(f"no boundary faces with attribute {attr}")
        belem = vol.bdr_elem[bsel]
        bface = vol.bdr_face[bsel]
        mesh = vol.mesh

        # surface quads in volume-vertex ids, cyclic order of the local face
        squads_vol = np.zeros((len(bsel), 4), dtype=np.int64)
        for fi in range(6):
            sel = np.where(bface == fi)[0]
            if len(sel):
                squads_vol[sel] = mesh.elems[np.ix_(belem[sel], HEX_FACES[fi])]
        used = np.unique(squads_vol)
        remap = np.full(mesh.n_verts, -1, dtype=np.int64)
        remap[used] = np.arange(len(used))
        squads = remap[squads_vol]

        self.elem_dofs, self.n_dofs = build_quad_dofs(squads, len(used), p)
        self.n_elems = len(bsel)

        # surface dof -> volume dof
        vol_face_dofs = vol.face_lattice_dofs(belem, bface)  # [nb, p1^2]
        s2v = np.full(self.n_dofs, -1, dtype=np.int64)
        s2v[self.elem_dofs.ravel()] = vol_face_dofs.ravel()
        if np.any(s2v < 0):
            raise AssertionError("surface dof without volume image")
        # consistency: every surface element must agree on the map
        if not np.all(s2v[self.elem_dofs] == vol_face_dofs):
            raise AssertionError("inconsistent surface-to-volume dof map")
        self.surf_to_vol = s2v
        self.node_coords = vol.node_coords[s2v]

    def project(self, fn) -> np.ndarray:
        X = self.node_coords
        return np.asarray(fn(X[:, 0], X[:, 1], X[:, 2]), dtype=np.float64)

    def max_error_quad(self, vals, fn, q: int | None = None) -> float:
        """Max-norm error with MFEM ``GridFunction::ComputeMaxError``
        semantics: the max runs over *element integration points* of an
        order-(2p+3) Gauss rule — not over the GLL nodes — exactly the
        dynamic-accuracy metric of
        ``Convergence_and_Scaling/convergence-parallel.cpp:269-271``
        (MFEM's default ``ComputeLpError(infinity(), ...)`` rule). Host
        NumPy; a diagnostic, not a hot path."""
        from .elements import basis_1d
        p1 = self.p + 1
        q = q if q is not None else self.p + 2    # exact for order 2p+3
        B = basis_1d(self.p, q).B                 # [q, p1]
        u = np.asarray(vals)[self.elem_dofs].reshape(-1, p1, p1)
        uq = np.einsum("by,ax,eyx->eba", B, B, u, optimize=True)
        X = np.asarray(self.node_coords)[self.elem_dofs].reshape(
            -1, p1, p1, 3).copy()
        # periodic wrap elements: the identified seam node reads the wrong
        # side of the domain (x: ... 0.97, 0.0), so the interpolated
        # geometry would sweep the whole period. Unwrap per element using
        # the true extent (corner_coords are stored unwrapped).
        mesh = self.vol.mesh
        for d in getattr(mesh, "periodic_axes", ()) or ():
            bbmin, bbmax = mesh.bounding_box()
            L = float(bbmax[d] - bbmin[d])
            Xd = X[..., d]
            emax = Xd.max(axis=(1, 2), keepdims=True)
            Xd[Xd < emax - 0.5 * L] += L
        Xq = np.einsum("by,ax,eyxd->ebad", B, B, X, optimize=True)
        ex = fn(Xq[..., 0], Xq[..., 1], Xq[..., 2])
        return float(np.max(np.abs(uq - ex)))
