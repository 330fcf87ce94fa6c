"""Half-cylinder diffraction tank mesh generator (host, NumPy).

Self-contained replacement for the reference's Gmsh meshes
(``Meshes/mesh_cylinder.geo``, ``mesh_cylinder_exact.geo``,
``mesh_cylinder_half.msh``): a bottom-mounted circular cylinder on the
symmetry plane of a half-domain wave tank, meshed as a single polar block —
rays from the cylinder center to the outer rectangle, geometrically graded
in radius (natural near-cylinder refinement, mirroring the Gmsh distance
threshold field ``mesh_cylinder.geo:52-63``) — extruded in z.

Boundary attributes follow ``mesh_cylinder_exact.geo:30-38``:
top (free surface) = 2, cylinder wall = 3, all other walls/bottom/symmetry
plane = 1 (natural zero-Neumann, so their exact attr is inert; the lateral
absorber zone is driven by y-coordinates, not attrs).

The gmsh import path (``lpfem.mesh.load_gmsh``) remains available for
externally generated meshes like the committed ``mesh_cylinder_half.msh``.
"""

from __future__ import annotations

import numpy as np

from .mesh import HEX_VERTS, Mesh

__all__ = ["make_half_cylinder_tank"]


def _ray_boundary_hit(c, d, Lx, y1):
    """Distance from c along unit direction d to the rectangle boundary
    [0,Lx] x [c_y, y1] (c sits on the bottom edge y = c_y)."""
    ts = []
    if d[0] > 1e-14:
        ts.append((Lx - c[0]) / d[0])
    if d[0] < -1e-14:
        ts.append((0.0 - c[0]) / d[0])
    if d[1] > 1e-14:
        ts.append((y1 - c[1]) / d[1])
    return min(t for t in ts if t > 0)


def make_half_cylinder_tank(Lx: float = 12.0, Ly: float = 6.0,
                            h: float = 1.0 / (2 * np.pi),
                            cx: float = 4.0, a: float = 0.5,
                            n_theta: int = 24, n_r: int = 12, nz: int = 2,
                            grading: float = 1.25,
                            geom_order: int | None = None,
                            dr0: float | None = None,
                            dr_max: float | None = None) -> Mesh:
    """Polar-block half-cylinder tank.

    Domain: [0,Lx] x [0,Ly] x [0,h] minus the half-disk of radius ``a``
    centered at (cx, 0) (the symmetry plane is y=0). ``grading`` > 1 packs
    radial layers toward the cylinder.

    Radial sizing: by default ``n_r`` geometrically graded layers (the
    outermost layer can get arbitrarily large on long rays — adequate for
    Laplace validation, NOT for wave propagation). Passing ``dr_max``
    switches to a capped profile — layers grow geometrically from ``dr0``
    (default: the rim arc length, for square near-cylinder elements) up to
    ``dr_max`` and stay there, and ``n_r`` is derived from the longest ray.
    The reference resolves its far field at ~0.5 wavelengths per element
    (``Meshes/mesh_cylinder_half.msh`` boundary spacing); ``dr_max`` is the
    equivalent knob here.

    The mesh is geometrically curved but *logically* a deformed box, so it
    declares ``elem_lattice`` and rides the gather-free structured E-vector
    transfer (no irregular gathers).
    """
    c = np.array([cx, 0.0])
    # theta grid with the rectangle's upper-corner angles as exact grid
    # points: otherwise the outer ring's straight chords cut the corners
    # (0.9% volume deficit) and the ray-length kinks fall inside elements.
    th_c1 = np.arctan2(Ly, Lx - cx)
    th_c2 = np.arctan2(Ly, -cx)
    arcs = [(0.0, th_c1), (th_c1, th_c2), (th_c2, np.pi)]
    lens = np.array([b - a_ for a_, b in arcs])
    counts = np.maximum(1, np.round(n_theta * lens / np.pi).astype(int))
    while counts.sum() > n_theta:
        counts[np.argmax(counts)] -= 1
    while counts.sum() < n_theta:
        counts[np.argmin(counts / np.maximum(lens, 1e-9))] += 1
    pieces = [np.linspace(a_, b, k, endpoint=False)
              for (a_, b), k in zip(arcs, counts)]
    thetas = np.concatenate(pieces + [[np.pi]])
    # radial fractions: capped profile (wave-resolving) or pure geometric
    if dr_max is not None:
        ray_len = max(_ray_boundary_hit(c, np.array([np.cos(t), np.sin(t)]),
                                        Lx, Ly) for t in thetas) - a
        w0 = dr0 if dr0 is not None else a * np.pi / n_theta
        widths = [min(w0, dr_max)]
        while sum(widths) < ray_len:
            widths.append(min(widths[-1] * grading, dr_max))
        w = np.asarray(widths)
        n_r = len(w)
    else:
        w = grading ** np.arange(n_r)
    frac = np.concatenate([[0.0], np.cumsum(w)]) / np.sum(w)

    # 2D node grid [n_theta+1, n_r+1, 2]
    pts = np.zeros((n_theta + 1, n_r + 1, 2))
    for i, th in enumerate(thetas):
        d = np.array([np.cos(th), np.sin(th)])
        t_out = _ray_boundary_hit(c, d, Lx, Ly)
        p0 = c + a * d
        p1 = c + t_out * d
        for j, f in enumerate(frac):
            pts[i, j] = p0 + f * (p1 - p0)

    # 2D vertex ids
    def vid2(i, j):
        return i * (n_r + 1) + j

    nv2 = (n_theta + 1) * (n_r + 1)
    verts2 = pts.reshape(-1, 2)

    # z levels
    zs = np.linspace(0.0, h, nz + 1)
    verts = np.zeros((nv2 * (nz + 1), 3))
    for k, z in enumerate(zs):
        verts[k * nv2:(k + 1) * nv2, :2] = verts2
        verts[k * nv2:(k + 1) * nv2, 2] = z

    def vid(i, j, k):
        return k * nv2 + vid2(i, j)

    # hexes: quad (i,j) x layer k. 2D quad cycle (ccw in x-y):
    # (i,j) -> (i,j+1) -> (i+1,j+1) -> (i+1,j) has positive orientation since
    # theta increases ccw and r outward: check below and fix orientation.
    elems, elat = [], []
    for i in range(n_theta):
        for j in range(n_r):
            # local x = +r (v0->v1), local y = +theta (v0->v3): positive
            # orientation (e_r x e_theta = +z) and lattice-aligned axes for
            # the structured renumber (ex, ey, ez) = (j, i, k)
            q = [vid2(i, j), vid2(i, j + 1), vid2(i + 1, j + 1), vid2(i + 1, j)]
            p = verts2[q]
            area = 0.0
            for m in range(4):
                x0, y0 = p[m]
                x1, y1 = p[(m + 1) % 4]
                area += x0 * y1 - x1 * y0
            assert area > 0, "polar quad unexpectedly clockwise"
            for k in range(nz):
                elems.append([q[0] + k * nv2, q[1] + k * nv2,
                              q[2] + k * nv2, q[3] + k * nv2,
                              q[0] + (k + 1) * nv2, q[1] + (k + 1) * nv2,
                              q[2] + (k + 1) * nv2, q[3] + (k + 1) * nv2])
                elat.append((j, i, k))
    elems = np.asarray(elems, dtype=np.int64)
    elat = np.asarray(elat, dtype=np.int64)

    # boundary quads: top z=h -> 2, cylinder r=a -> 3, rest -> 1
    bq, ba = [], []
    # top/bottom faces per 2D quad
    for i in range(n_theta):
        for j in range(n_r):
            q = [vid2(i, j), vid2(i, j + 1), vid2(i + 1, j + 1), vid2(i + 1, j)]
            bq.append([v + nz * nv2 for v in q])
            ba.append(2)                      # free surface
            bq.append(list(q))
            ba.append(1)                      # bottom
    # cylinder wall: j = 0 ring
    for i in range(n_theta):
        for k in range(nz):
            bq.append([vid(i, 0, k), vid(i + 1, 0, k),
                       vid(i + 1, 0, k + 1), vid(i, 0, k + 1)])
            ba.append(3)
    # outer boundary: j = n_r ring (tank walls)
    for i in range(n_theta):
        for k in range(nz):
            bq.append([vid(i, n_r, k), vid(i + 1, n_r, k),
                       vid(i + 1, n_r, k + 1), vid(i, n_r, k + 1)])
            ba.append(1)
    # symmetry plane segments: theta = 0 and theta = pi rows (y = 0)
    for j in range(n_r):
        for k in range(nz):
            bq.append([vid(0, j, k), vid(0, j + 1, k),
                       vid(0, j + 1, k + 1), vid(0, j, k + 1)])
            ba.append(1)
            bq.append([vid(n_theta, j, k), vid(n_theta, j + 1, k),
                       vid(n_theta, j + 1, k + 1), vid(n_theta, j, k + 1)])
            ba.append(1)

    mesh = Mesh(verts=verts, elems=elems, corner_coords=verts[elems],
                bdr_quads=np.asarray(bq, dtype=np.int64),
                bdr_attrs=np.asarray(ba, dtype=np.int64),
                elem_lattice=elat, lattice_dims=(n_r, n_theta, nz))
    if geom_order:
        set_cylinder_geometry(mesh, geom_order, Lx=Lx, Ly=Ly, cx=cx, a=a)
    return mesh


def set_cylinder_geometry(mesh: Mesh, pg: int, Lx: float, Ly: float,
                          cx: float, a: float) -> None:
    """Attach exact curved (isoparametric) geometry of order ``pg``.

    The MFEM ``SetCurvature(order)`` analogue (``cylinder-diffraction.cpp:264``)
    — but *better than the reference*: MFEM's SetCurvature on a linear Gmsh
    mesh merely re-interpolates the faceted geometry, while here each
    element's nodes are placed by the exact polar blend
    ``x(theta, f) = c + (a + f (t_out(theta) - a)) d(theta)``, so the
    cylinder rim is exactly circular at any order.
    """
    from .elements import basis_1d

    gll = basis_1d(pg).nodes
    pg1 = pg + 1
    c = np.array([cx, 0.0])
    cc = mesh.corner_coords                       # [ne, 8, 3]
    ne = cc.shape[0]

    # corner parameters (theta, f, z)
    dx = cc[..., 0] - cx
    dy = cc[..., 1]
    theta_c = np.arctan2(dy, dx)                  # [ne, 8] in [0, pi]
    theta_c = np.where(theta_c < 0, 0.0, theta_c)
    r_c = np.hypot(dx, dy)
    tout_c = np.array([[_ray_boundary_hit(c, np.array([np.cos(t), np.sin(t)]),
                                          Lx, Ly) for t in row]
                       for row in theta_c])
    f_c = (r_c - a) / np.maximum(tout_c - a, 1e-30)
    z_c = cc[..., 2]

    # trilinear weights at the pg-lattice (HEX_VERTS corner order)
    W = np.zeros((pg1 ** 3, 8))
    for iz in range(pg1):
        for iy in range(pg1):
            for ix in range(pg1):
                n = ix + pg1 * (iy + pg1 * iz)
                u, v, w = gll[ix], gll[iy], gll[iz]
                for vi, (ax_, ay_, az_) in enumerate(HEX_VERTS):
                    W[n, vi] = ((u if ax_ else 1 - u) * (v if ay_ else 1 - v)
                                * (w if az_ else 1 - w))

    th = np.einsum("lk,ek->el", W, theta_c)        # [ne, L]
    f = np.einsum("lk,ek->el", W, f_c)
    z = np.einsum("lk,ek->el", W, z_c)
    tout = np.vectorize(
        lambda t: _ray_boundary_hit(c, np.array([np.cos(t), np.sin(t)]),
                                    Lx, Ly))(th)
    r = a + f * (tout - a)
    # The exact polar map: valid everywhere because the theta grid places
    # the rectangle-corner angles (the kinks of t_out) on element
    # boundaries, so within each element the map is smooth.
    mesh.geom_nodes = np.stack([cx + r * np.cos(th), r * np.sin(th), z],
                               axis=-1)
    mesh.geom_order = pg
