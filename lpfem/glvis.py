"""GLVis socket streaming.

Counterpart of the reference's live visualization
(``Solvers/PF_linear_serial.cpp:438-487``): MFEM opens a ``socketstream`` to
a running ``glvis`` server (default ``localhost:19916``) and streams
``"solution\\n" << mesh << gridfunction`` once per visualization step, plus a
``keys`` string for the initial view.

Here the high-order field is streamed as the GLL-subdivided *linear*
visualization mesh (the same levels-of-detail refinement
:func:`lpfem.io.volume_cells` / :func:`surface_cells` use for ParaView) with
an ``H1 P1`` grid function. For P1, MFEM's dof ordering *is* the mesh vertex
ordering, so a stock GLVis binary renders the payload directly — no
replication of MFEM's edge/face dof enumeration is needed, and every GLL
node is represented exactly.

The socket is optional, exactly like the reference: if no GLVis server is
listening the stream disables itself after one warning and the solver runs
on (MFEM prints "Unable to connect to GLVis server" and continues,
``PF_linear_serial.cpp:447-455``).
"""

from __future__ import annotations

import socket

import numpy as np

from .io import surface_cells, volume_cells

__all__ = ["GLVisStream", "solution_text", "parallel_solution_text"]


def _mesh_text(points: np.ndarray, conn: np.ndarray, dim: int) -> str:
    """MFEM v1.0 mesh for the linear visualization cells (hexes or quads
    embedded in 3D)."""
    geom = 5 if conn.shape[1] == 8 else 3          # hex / quad
    buf = [f"MFEM mesh v1.0\n\ndimension\n{dim}\n\n"]
    buf.append(f"elements\n{len(conn)}\n")
    buf.extend("1 %d %s\n" % (geom, " ".join(map(str, c))) for c in conn)
    # the viz mesh needs no boundary; GLVis derives faces itself
    buf.append("\nboundary\n0\n")
    buf.append(f"\nvertices\n{len(points)}\n{points.shape[1]}\n")
    buf.extend(" ".join(f"{v:.16g}" for v in p) + "\n" for p in points)
    return "".join(buf)


def _gf_text(values: np.ndarray, dim: int) -> str:
    """MFEM GridFunction: P1 nodal values in mesh vertex order."""
    head = (f"FiniteElementSpace\nFiniteElementCollection: H1_{dim}D_P1\n"
            "VDim: 1\nOrdering: 0\n\n")
    return head + "\n".join(f"{v:.16g}" for v in np.asarray(values).ravel()) + "\n"


def solution_text(sp, values, keys: str | None = None) -> str:
    """The full ``solution`` payload for a volume (:class:`~lpfem.space.H1Space`)
    or surface (:class:`~lpfem.space.SurfaceSpace`) field.

    ``values`` is a dof vector on ``sp``; it is expanded to the per-element
    GLL lattice (duplicating shared nodes, which is what MFEM's L-vector
    stream carries too)."""
    vals = np.asarray(values)[np.asarray(sp.elem_dofs)].reshape(-1)
    if sp.elem_dofs.shape[1] == (sp.p + 1) ** 3:       # volume space
        pts, conn = volume_cells(sp)
        dim = 3
    else:                                              # surface trace space
        pts, conn = surface_cells(sp)
        dim = 2
    txt = "solution\n" + _mesh_text(pts, conn, dim) + "\n" + _gf_text(vals, dim)
    if keys:
        txt += f"keys {keys}\n"
    return txt


def _piece(sp, values, nranks: int, rank: int):
    """Rank-``rank``'s contiguous element slice of the visualization cells
    (the z-slab shard analogue). Points are per-element duplicated, so the
    slice is a pure row range."""
    vals = np.asarray(values)[np.asarray(sp.elem_dofs)].reshape(-1)
    if sp.elem_dofs.shape[1] == (sp.p + 1) ** 3:
        pts, conn = volume_cells(sp)
        dim = 3
    else:
        pts, conn = surface_cells(sp)
        dim = 2
    ne = sp.elem_dofs.shape[0]
    L = sp.elem_dofs.shape[1]
    nsub = conn.shape[0] // ne
    bounds = np.linspace(0, ne, nranks + 1).astype(int)
    e0, e1 = bounds[rank], bounds[rank + 1]
    pts_r = pts[e0 * L:e1 * L]
    vals_r = vals[e0 * L:e1 * L]
    conn_r = conn[e0 * nsub:e1 * nsub] - e0 * L
    return pts_r, conn_r, vals_r, dim


def parallel_solution_text(sp, values, nranks: int, rank: int,
                           keys: str | None = None) -> str:
    """One rank's payload of the GLVis *parallel* stream: the
    ``"parallel " << nranks << " " << rank`` handshake the reference's
    parallel programs emit before their piece of the mesh + grid function
    (``Solvers/laplace_solver_parallel.cpp:166-172``). GLVis reassembles
    the pieces from one connection per rank; here a single process plays
    all ranks (the shard analogue of MFEM's per-MPI-rank socketstream)."""
    pts, conn, vals, dim = _piece(sp, values, nranks, rank)
    txt = (f"parallel {nranks} {rank}\n"
           "solution\n" + _mesh_text(pts, conn, dim) + "\n"
           + _gf_text(vals, dim))
    if keys and rank == 0:
        txt += f"keys {keys}\n"
    return txt


class GLVisStream:
    """Persistent connection to a GLVis server, reference-style.

    >>> vis = GLVisStream()                   # localhost:19916
    >>> vis.send(prob.surf, eta, keys="Rjlc") # once per vis step

    ``send`` returns True if the payload was written. Connection failures
    (no server) disable the stream after one warning instead of raising —
    the solver must not die because nobody is watching.
    """

    def __init__(self, host: str = "localhost", port: int = 19916,
                 timeout: float = 2.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._sock: socket.socket | None = None
        self._disabled = False

    def _connect(self) -> bool:
        if self._sock is not None:
            return True
        if self._disabled:
            return False
        try:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout)
            return True
        except OSError as e:
            print(f"glvis: unable to connect to {self.host}:{self.port} "
                  f"({e}); live visualization disabled")
            self._disabled = True
            return False

    def send(self, sp, values, keys: str | None = None) -> bool:
        if not self._connect():
            return False
        try:
            self._sock.sendall(solution_text(sp, values, keys=keys).encode())
            return True
        except OSError as e:
            print(f"glvis: send failed ({e}); live visualization disabled")
            self.close()
            self._disabled = True
            return False

    def send_parallel(self, sp, values, nranks: int,
                      keys: str | None = None) -> bool:
        """Stream ``nranks`` pieces over one connection per rank — the
        reference's parallel-GLVis handshake
        (``Solvers/laplace_solver_parallel.cpp:166-172``), with this
        process playing every rank. Connections persist across sends."""
        if self._disabled:
            return False
        socks = getattr(self, "_psocks", None)
        if socks is None or len(socks) != nranks:
            try:
                socks = [socket.create_connection(
                    (self.host, self.port), timeout=self.timeout)
                    for _ in range(nranks)]
            except OSError as e:
                print(f"glvis: unable to connect to {self.host}:{self.port} "
                      f"({e}); live visualization disabled")
                self._disabled = True
                return False
            self._psocks = socks
        try:
            for rank, s in enumerate(socks):
                s.sendall(parallel_solution_text(
                    sp, values, nranks, rank, keys=keys).encode())
            return True
        except OSError as e:
            print(f"glvis: send failed ({e}); live visualization disabled")
            self.close()
            self._disabled = True
            return False

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
        for s in getattr(self, "_psocks", None) or []:
            try:
                s.close()
            except OSError:
                pass
        self._psocks = None
