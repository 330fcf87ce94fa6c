"""Native (C++) host-runtime kernels with ctypes bindings.

The reference's host-side machinery is C++ (MFEM); here the numerics run in
JAX/XLA on the accelerator, and the host runtime pieces that benefit from native speed —
topological dof numbering, mesh refinement — are C++ with a NumPy fallback.

The shared library is built on demand with ``g++`` (cached next to the
source); if no toolchain is available everything silently falls back to the
NumPy implementations in :mod:`lpfem.space` / :mod:`lpfem.mesh`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(__file__)
_SRCS = [os.path.join(_HERE, "dofs.cpp"), os.path.join(_HERE, "vtuio.cpp")]

_lib = None
_tried = False

_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)


def _so_path() -> str:
    """Library path keyed by a hash of the sources: a stale binary (e.g.
    from a fresh clone where checkout mtimes are meaningless) can never be
    loaded against newer sources."""
    import hashlib
    h = hashlib.sha256()
    for s in _SRCS:
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(_HERE, f"liblpfem_native-{h.hexdigest()[:16]}.so")


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        so = _so_path()
        if not os.path.exists(so):
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", *_SRCS,
                 "-o", so],
                check=True, capture_output=True, timeout=120)
        lib = ctypes.CDLL(so)
        lib.lpfem_build_hex_dofs.restype = ctypes.c_int64
        lib.lpfem_build_hex_dofs.argtypes = [
            _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i64p]
        lib.lpfem_write_vtu.restype = ctypes.c_int64
        lib.lpfem_write_vtu.argtypes = [
            ctypes.c_char_p, _f64p, ctypes.c_int64, _i64p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p,
            ctypes.POINTER(_f64p), ctypes.c_int64]
        lib.lpfem_gmsh_open.restype = ctypes.c_void_p
        lib.lpfem_gmsh_open.argtypes = [ctypes.c_char_p]
        lib.lpfem_gmsh_counts.restype = ctypes.c_int64
        lib.lpfem_gmsh_counts.argtypes = [ctypes.c_void_p, _i64p]
        lib.lpfem_gmsh_fill.restype = ctypes.c_int64
        lib.lpfem_gmsh_fill.argtypes = [ctypes.c_void_p, _f64p, _i64p,
                                        _i64p, _i64p]
        lib.lpfem_gmsh_free.restype = None
        lib.lpfem_gmsh_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def build_hex_dofs(elems: np.ndarray, n_verts: int, p: int):
    """Native topological dof numbering; returns (elem_dofs, n_dofs) or None
    if the native library is unavailable.

    Note: edge/face ids use first-encounter order (the NumPy path uses
    sorted-unique order), so raw dof ids differ by a permutation; all
    topological invariants (sharing pattern, counts) are identical. Use one
    path consistently per space — :class:`lpfem.space.H1Space` does.
    """
    lib = _load()
    if lib is None:
        return None
    elems = np.ascontiguousarray(elems, dtype=np.int64)
    ne = elems.shape[0]
    out = np.zeros((ne, (p + 1) ** 3), dtype=np.int64)
    n = lib.lpfem_build_hex_dofs(
        elems.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ne, int(n_verts), int(p),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if n < 0:
        return None
    return out, int(n)


def write_vtu_binary(path: str, points: np.ndarray, conn: np.ndarray,
                     cell_type: int, fields: dict[str, np.ndarray]) -> bool:
    """Native binary-appended VTU write (fwrite of raw little-endian
    blocks); returns False when the native library is unavailable so the
    caller falls back to the ASCII writer. The reference's equivalent is
    MFEM's C++ ParaViewDataCollection (``Solvers/PF_linear_par.cpp:433-449``)."""
    lib = _load()
    if lib is None:
        return False
    points = np.ascontiguousarray(points, dtype=np.float64)
    conn = np.ascontiguousarray(conn, dtype=np.int64)
    npts = points.shape[0]
    ncell, nverts = conn.shape
    names = list(fields)
    arrs = [np.ascontiguousarray(np.asarray(fields[k]).ravel(),
                                 dtype=np.float64) for k in names]
    for a in arrs:
        if a.shape[0] != npts:
            raise ValueError("field length != number of points")
    fnames = b"\0".join(n.encode() for n in names) + b"\0"
    fptrs = (_f64p * max(len(arrs), 1))(
        *[a.ctypes.data_as(_f64p) for a in arrs])
    rc = lib.lpfem_write_vtu(
        path.encode(), points.ctypes.data_as(_f64p), npts,
        conn.ctypes.data_as(_i64p), ncell, nverts, int(cell_type),
        fnames, fptrs, len(arrs))
    return rc == 0


def parse_gmsh(path: str):
    """Native Gmsh v2.2 parse; returns (verts [nn,3], hexes [nh,8],
    quads [nq,4], qtags [nq]) or None when unavailable (caller falls back
    to the Python parser in :mod:`lpfem.mesh`)."""
    lib = _load()
    if lib is None:
        return None
    h = lib.lpfem_gmsh_open(path.encode())
    if not h:
        return None
    try:
        counts = np.zeros(3, dtype=np.int64)
        if lib.lpfem_gmsh_counts(h, counts.ctypes.data_as(_i64p)) != 0:
            return None
        nn, nh, nq = (int(c) for c in counts)
        verts = np.zeros((nn, 3))
        hexes = np.zeros((nh, 8), dtype=np.int64)
        quads = np.zeros((max(nq, 1), 4), dtype=np.int64)
        qtags = np.zeros(max(nq, 1), dtype=np.int64)
        if lib.lpfem_gmsh_fill(h, verts.ctypes.data_as(_f64p),
                               hexes.ctypes.data_as(_i64p),
                               quads.ctypes.data_as(_i64p),
                               qtags.ctypes.data_as(_i64p)) != 0:
            return None
        return verts, hexes, quads[:nq], qtags[:nq]
    finally:
        lib.lpfem_gmsh_free(h)
