"""Device-mesh domain decomposition: shard_map + XLA collectives replace MPI.

Equivalent of the reference's single parallelism strategy — MPI
domain decomposition via ``ParMesh(MPI_COMM_WORLD, serial_mesh)`` with
hypre/MFEM shared-dof communication (``Solvers/laplace_solver_parallel.cpp:76-78``,
SURVEY.md §2 'Parallelism strategies', §5 'Distributed communication backend').

Design (maps the MPI inventory 1:1 onto XLA collectives over a 1-axis mesh):

- Elements are partitioned into contiguous slabs by centroid (x-major), one
  per device; every per-element table is padded to ``E_max`` and stacked
  ``[ndev, E_max, ...]`` so the whole state is SPMD.
- Each dof is owned by the lowest-id device touching it; global dofs are
  renumbered owner-major so each device holds a contiguous owned block,
  padded to ``N_max``.
- Partition-interface dofs form a small global set S (``O(N^(2/3))``). A
  single ``lax.psum`` of an ``|S|+1`` buffer implements both directions of
  hypre's ParCSR assemble: value broadcast (owner sets, others read their
  halo) and contribution reduction (neighbors add, owner accumulates).
  This is the collective analogue of MFEM's T-dof <-> L-dof exchange.
- CG dot products: local dot + ``lax.psum`` — the reference's
  ``MPI_Allreduce`` (``Convergence_and_Scaling/ss.cpp:271-276``).
- The free-surface state (a 2D trace, asymptotically negligible) is
  replicated; surface gathers ride the same psum buffer — the analogue of
  the diffraction driver's ``MPI_Allgatherv`` (``cylinder-diffraction.cpp:537-560``).
- The p-multigrid preconditioner shards level-by-level: every level's space
  is partitioned over the SAME element slabs, so transfers are element-local
  interpolations + the level's own interface assembly.

Everything — halo exchange, CG, the V-cycle, RK4 — runs inside ONE
``shard_map``-ed jit; XLA hands the collectives to NCCL on GPUs, and there
are no host round-trips (the MPI build pays a host-side Allreduce per CG
dot). The device mesh is one axis: on a host whose cards are joined all to
all (NVLink), every neighbour exchange costs the same.

Padding conventions: local trash lane = ``N_max`` (vectors are length
``N_max+1``; sliced off after assembly), interface trash slot = ``NS``
(buffers are ``NS+1``), surface trash = ``NSurf``.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .operators import LaplacePA, _apply_G6, _apply_G6_affine
from .problem import Problem
from .solvers import pcg, pcg_ir
from .timestep import rk4_run

__all__ = ["Partition", "ShardedLevel", "ShardedProblem", "make_device_mesh"]

_HI = jax.lax.Precision.HIGHEST


def make_device_mesh(n_dev: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()[: n_dev or len(jax.devices())]
    return Mesh(np.array(devices), ("shard",))


def sharded_put(mesh: Mesh):
    """Placer for [ndev, ...] stacked tables: each device receives ONLY its
    slice (``jax.device_put`` with a leading-axis NamedSharding). Without
    this, ``jnp.asarray`` commits the whole stacked array to the default
    device first — which caps the sharded path at one device's memory and
    defeats domain decomposition (the reference's ParMesh never holds the
    global problem on one rank, ``Solvers/laplace_solver_parallel.cpp:76-78``).
    """
    from jax.sharding import NamedSharding
    ns = NamedSharding(mesh, P("shard"))

    def put(a):
        return jax.device_put(np.asarray(a), ns)

    return put


def _zslab_layers(part: np.ndarray, elem_dims, ndev: int):
    """Per-device ``(ez0, n_layers)`` if ``part`` is a contiguous z-layer slab
    partition of the element lattice (every device owns whole, consecutive
    element layers, each at least one), else ``None``."""
    nex, ney, nez = elem_dims
    if len(part) != nex * ney * nez:
        return None
    p3 = part.reshape(nez, ney, nex)
    layer_dev = p3[:, 0, 0]
    if not np.all(p3 == layer_dev[:, None, None]):
        return None
    if np.any(np.diff(layer_dev) != np.clip(np.diff(layer_dev), 0, 1)):
        return None
    nlay = np.bincount(layer_dev, minlength=ndev)
    if len(nlay) != ndev or np.any(nlay < 1):
        return None
    ez0 = np.concatenate([[0], np.cumsum(nlay)[:-1]])
    return ez0, nlay


class Partition:
    """Host-side partition tables for an :class:`H1Space` over ``ndev`` shards.

    ``part`` (element -> device) may be supplied so multiple spaces (the MG
    level hierarchy) share one element decomposition.

    ``layout`` selects the per-device dof numbering:

    - ``"compact"`` — owner-major contiguous blocks (global-order stable).
    - ``"lattice"`` — *window* layout on structured spaces partitioned into
      z-layer slabs: each device's owned block is laid out as its local
      sub-lattice ``[p*nez_loc+1, Dy, Dx]`` (plane 0 = the halo plane owned
      by the lower neighbor, real for device 0; trailing planes = padding on
      devices with fewer layers). The owned vector then *is* the separable
      apply's input window up to one halo-plane injection — no irregular
      gathers anywhere on the sharded hot path (the reason the
      reference's fastest assembly mode runs under MPI,
      ``Solvers/PF_linear_par_partial.cpp:118-124``).
    - ``"auto"`` — lattice when the space qualifies, else compact.

    ``lat_loc=(loc_of_dof, N_max, win)`` force-inherits a window layout from
    another Partition sharing the same dof lattice (the MG h-transfer 'via'
    space).
    """

    def __init__(self, space, ndev: int, part: np.ndarray | None = None,
                 owner: np.ndarray | None = None, layout: str = "auto",
                 lat_loc: tuple | None = None):
        self.ndev = ndev
        ed = space.elem_dofs
        ne, L = ed.shape
        n = space.n_dofs
        st = getattr(space, "struct", None)

        if part is None:
            zslab = (layout in ("auto", "lattice") and st is not None
                     and not st.periodic[2] and st.elem_dims[2] >= ndev)
            if zslab:
                # contiguous z-layer slabs (larger slabs first so device 0
                # always carries the padded layer count)
                nex, ney, nez = st.elem_dims
                layer_of = np.zeros(nez, dtype=np.int64)
                for d, idx in enumerate(np.array_split(np.arange(nez), ndev)):
                    layer_of[idx] = d
                part = np.repeat(layer_of, ney * nex)
            else:
                # contiguous slabs by element centroid (x, y, z)-major
                cen = space.mesh.corner_coords.mean(axis=1)
                order = np.lexsort((cen[:, 2], cen[:, 1], cen[:, 0]))
                part = np.zeros(ne, dtype=np.int64)
                for d, idx in enumerate(np.array_split(order, ndev)):
                    part[idx] = d
        self.part = part

        # --- dof ownership: min / max device touching each dof ---
        pmin = np.full(n, ndev, dtype=np.int64)
        pmax = np.full(n, -1, dtype=np.int64)
        pe = np.repeat(part, L)
        np.minimum.at(pmin, ed.ravel(), pe)
        np.maximum.at(pmax, ed.ravel(), pe)
        if owner is None:
            owner = pmin
        else:
            # inherited ownership (the MG h-transfer 'via' space adopts the
            # fine level's dof layout so transfers need no re-layout); a dof
            # is interface whenever any toucher differs from the owner
            owner = np.asarray(owner)
        self.owner = owner
        self.pmin, self.pmax = pmin, pmax
        iface = (pmin != owner) | (pmax != owner)
        self.n_iface = int(iface.sum())

        n_own = np.bincount(owner, minlength=ndev)
        self.n_own = n_own
        self.win = None
        sl = (_zslab_layers(np.asarray(part), st.elem_dims, ndev)
              if (st is not None and layout != "compact"
                  and not st.periodic[2]) else None)
        if sl is not None and sl[1][0] != sl[1].max():
            # the window layout needs device 0 to carry the largest slab
            # (its window holds the extra z=0 plane, making N_max its own
            # count); a user-supplied contiguous z-slab partition with small
            # slabs first is valid but does not qualify — use the compact
            # layout rather than asserting
            sl = None
        if lat_loc is not None:
            # inherited window layout (the h-transfer 'via' space shares the
            # fine level's dof lattice; see ShardedPMG)
            loc_of_dof, self.N_max, self.win = lat_loc
            self.loc_of_dof = loc_of_dof
        elif sl is not None and owner is pmin:
            # ---- lattice (window) layout over z-layer slabs ----
            ez0, nlay = sl
            p = space.p
            Dx, Dy, Dz = st.dof_dims
            plane = Dx * Dy
            nez_loc = int(nlay.max())
            # device 0 carries the padded layer count (guaranteed by the
            # eligibility check above): its window holds the extra z=0
            # plane, making N_max == its own count
            z = np.arange(n) // plane
            rem = np.arange(n) % plane
            loc_of_dof = (z - p * ez0[owner]) * plane + rem
            self.N_max = (p * nez_loc + 1) * plane
            assert np.all((loc_of_dof >= 0) & (loc_of_dof < self.N_max))
            self.loc_of_dof = loc_of_dof
            self.win = {
                "p": p, "dims": (st.elem_dims[0], st.elem_dims[1], nez_loc),
                "ez0": ez0, "nlay": nlay, "Dx": Dx, "Dy": Dy,
                "Dz_win": p * nez_loc + 1, "plane": plane,
                "periodic": (bool(st.periodic[0]), bool(st.periodic[1])),
            }
        else:
            # ---- compact layout: owner-major contiguous blocks ----
            new_of_old = np.argsort(np.argsort(owner, kind="stable"),
                                    kind="stable")
            offs = np.concatenate([[0], np.cumsum(n_own)])
            loc_of_dof = new_of_old - offs[owner]
            self.N_max = int(n_own.max())
            self.loc_of_dof = loc_of_dof

        # interface set S (order: by dof id)
        s_ids = np.where(iface)[0]
        NS = len(s_ids)
        self.NS = NS
        s_pos = np.full(n, -1, dtype=np.int64)
        s_pos[s_ids] = np.arange(NS)
        self.s_pos = s_pos

        N_max = self.N_max
        elems_of = [np.where(part == d)[0] for d in range(ndev)]
        self.elems_of = elems_of
        E_max = max(len(e) for e in elems_of)
        self.E_max = E_max

        led = np.full((ndev, E_max, L), N_max, dtype=np.int64)
        halo_of = []
        for d in range(ndev):
            dofs = ed[elems_of[d]]
            halo_of.append(np.unique(dofs[owner[dofs] != d]))
        H_max = max((len(h) for h in halo_of), default=0)
        self.H_max = H_max

        halo_pos = np.full((ndev, max(H_max, 1)), NS, dtype=np.int64)
        own_if_pos_l, own_if_loc_l = [], []
        for d in range(ndev):
            es = elems_of[d]
            dofs = ed[es]
            own_mask = owner[dofs] == d
            halo_ids = halo_of[d]
            h_idx = np.full(n, -1, dtype=np.int64)
            h_idx[halo_ids] = np.arange(len(halo_ids))
            # local layout: [own(N_max), trash(1), halo(H_max), htrash(1)]
            local = np.where(own_mask, loc_of_dof[dofs], N_max + 1 + h_idx[dofs])
            led[d, : len(es)] = local
            assert np.all(s_pos[halo_ids] >= 0)
            halo_pos[d, : len(halo_ids)] = s_pos[halo_ids]
            o_ids = np.where((owner == d) & iface)[0]
            own_if_pos_l.append(s_pos[o_ids])
            own_if_loc_l.append(loc_of_dof[o_ids])

        self.local_elem_dofs = led.astype(np.int32)
        self.elem_dofs_global = ed            # reference, not a copy
        NIo_max = max(max((len(a) for a in own_if_pos_l), default=0), 1)
        oip = np.full((ndev, NIo_max), NS, dtype=np.int64)
        oil = np.full((ndev, NIo_max), N_max, dtype=np.int64)
        for d in range(ndev):
            k = len(own_if_pos_l[d])
            oip[d, :k] = own_if_pos_l[d]
            oil[d, :k] = own_if_loc_l[d]
        self.own_if_pos = oip.astype(np.int32)
        self.own_if_loc = oil.astype(np.int32)
        self.halo_pos = halo_pos.astype(np.int32)

    # ------------------------------------------------------------- helpers
    def stack_elem(self, arr: np.ndarray, fill=0.0) -> np.ndarray:
        out = np.full((self.ndev, self.E_max) + arr.shape[1:], fill,
                      dtype=arr.dtype)
        for d, es in enumerate(self.elems_of):
            out[d, : len(es)] = arr[es]
        return out

    def stack_dof(self, vec: np.ndarray, fill=0.0) -> np.ndarray:
        out = np.full((self.ndev, self.N_max + 1) + vec.shape[1:], fill,
                      dtype=vec.dtype)
        for d in range(self.ndev):
            ids = np.where(self.owner == d)[0]
            out[d, self.loc_of_dof[ids]] = vec[ids]
        return out

    def unstack_dof(self, stacked: np.ndarray) -> np.ndarray:
        n = len(self.owner)
        out = np.zeros((n,) + stacked.shape[2:], dtype=stacked.dtype)
        for d in range(self.ndev):
            ids = np.where(self.owner == d)[0]
            out[ids] = stacked[d, self.loc_of_dof[ids]]
        return out


class ShardedExchange:
    """Interface-exchange machinery for one Partition: the T-dof <-> L-dof /
    E-vector transfer primitives used inside shard_map.

    Holds only the index tables (no operator); :class:`ShardedLevel` extends
    it with the operator data. MG h-transfer 'via' spaces use this class
    directly (a p=2 space on the half mesh that shares the fine level's dof
    layout — see :class:`ShardedPMG`).
    """

    def __init__(self, pt: Partition, axis: str = "shard",
                 exchange: str = "auto", put=None):
        self.pt = pt
        self.axis = axis
        self._put = put if put is not None else jnp.asarray
        # pad the halo segment to >=1 so zero-halo (single-shard) partitions
        # keep static shapes consistent with the [ndev, max(H_max,1)] tables
        self.N_max, self.H_max, self.NS = pt.N_max, max(pt.H_max, 1), pt.NS
        self.tables = {
            "led": self._put(pt.local_elem_dofs),
            "oip": self._put(pt.own_if_pos),
            "oil": self._put(pt.own_if_loc),
            "hp": self._put(pt.halo_pos),
        }
        self.exchange = "psum"
        if exchange in ("auto", "ppermute") and self._build_neighbor_tables():
            self.exchange = "ppermute"
        elif exchange == "ppermute":
            raise ValueError("partition is not neighbor-only; ppermute "
                             "exchange unavailable (use 'auto' or 'psum')")
        self.win = pt.win
        self._lat = None
        if self.win is not None:
            self._init_window()

    def _init_window(self) -> None:
        """Window-layout machinery: on the lattice dof layout each device's
        owned vector reshapes directly to its local sub-lattice, the halo is
        exactly the window's plane 0 (in plane order), and E-vector
        gather/scatter runs through :class:`~lpfem.operators.StructuredLattice`
        fold/unfold — no [E_max, L] irregular gathers on the sharded path."""
        from .operators import StructuredLattice
        from .space import StructuredInfo
        w = self.win
        pt = self.pt
        ndev = pt.ndev
        nex, ney, nez_loc = w["dims"]
        st_loc = StructuredInfo(
            dof_dims=(w["Dx"], w["Dy"], w["Dz_win"]),
            elem_dims=(nex, ney, nez_loc),
            periodic=(w["periodic"][0], w["periodic"][1], False))
        self._lat = StructuredLattice(st_loc, w["p"])
        assert self._lat.ne == pt.E_max, (self._lat.ne, pt.E_max)
        assert self.N_max == w["Dz_win"] * w["plane"]
        # the halo segment must be exactly the window's plane 0 in plane
        # order for every device with a lower neighbor (guaranteed for
        # z-slab partitions with min-owner dofs; asserted at build time)
        ed = pt.elem_dofs_global
        for d in range(1, ndev):
            dofs = np.unique(ed[pt.elems_of[d]])
            halo = dofs[pt.owner[dofs] != d]
            z0 = w["p"] * w["ez0"][d]
            expect = z0 * w["plane"] + np.arange(w["plane"])
            assert np.array_equal(halo, expect), \
                "window layout requires plane-order halos"
        own0 = np.zeros((ndev, 1), dtype=np.int32)
        own0[0] = 1
        self.tables["ko"] = self._put(own0)

    def _build_neighbor_tables(self) -> bool:
        """Neighbor (ppermute) exchange tables for slab partitions.

        Valid when every interface dof is shared by exactly TWO ring-adjacent
        devices: owner d with toucher d+1 ('forward' seams), or owner 0 with
        toucher ndev-1 (the periodic wrap seam). Halo values then flow as
        ppermutes of each device's O(|S|/ndev) boundary segments instead of
        a psum of the whole O(|S|) interface buffer — per-device traffic
        drops ~ndev-fold and latency is one transfer instead of a reduction (the MPI-neighbor-exchange
        analogue of hypre's ParCSR comm package, vs the reference's
        Allreduce; ss.cpp:271-276). Falls back to psum when invalid.
        """
        pt = self.pt
        ndev = pt.ndev
        if ndev == 1:
            return False
        pmin, pmax, owner = pt.pmin, pt.pmax, pt.owner
        n = len(owner)
        iface = (pmin != owner) | (pmax != owner)
        ids = np.where(iface)[0]
        if len(ids) == 0:
            return False
        # distinct toucher count per dof
        space_ed = pt.elem_dofs_global
        n_touch = np.zeros(n, dtype=np.int64)
        for d, es in enumerate(pt.elems_of):
            n_touch[np.unique(space_ed[es])] += 1
        fwd = (n_touch[ids] == 2) & (pmax[ids] == pmin[ids] + 1) \
            & (owner[ids] == pmin[ids])
        wrap = (n_touch[ids] == 2) & (pmin[ids] == 0) \
            & (pmax[ids] == ndev - 1) & (owner[ids] == 0) & (ndev > 2)
        if not np.all(fwd | wrap):
            return False
        ids_f, ids_w = ids[fwd], ids[wrap]

        def seg_tables(seg_ids, src_of):
            """sender gather table [ndev, W_max] of owner-local indices,
            per-device sorted by global dof id."""
            W = np.bincount(src_of[seg_ids], minlength=ndev)
            W_max = max(int(W.max()), 1)
            g = np.full((ndev, W_max), pt.N_max, dtype=np.int64)
            for d in range(ndev):
                own_ids = np.sort(seg_ids[src_of[seg_ids] == d])
                g[d, : len(own_ids)] = pt.loc_of_dof[own_ids]
            return g, W_max

        gsl_f, Wf = seg_tables(ids_f, owner)
        gsl_w, Ww = seg_tables(ids_w, owner)

        # receiver: map each halo slot to its position in the concat
        # [recv_fwd(Wf), recv_wrap(Ww), trash(1)] buffer
        hr = np.full((self.pt.ndev, max(pt.H_max, 1)), Wf + Ww, dtype=np.int64)
        rank_f = np.full(n, -1, dtype=np.int64)
        rank_w = np.full(n, -1, dtype=np.int64)
        for d in range(ndev):
            sf = np.sort(ids_f[owner[ids_f] == d])
            rank_f[sf] = np.arange(len(sf))
            sw = np.sort(ids_w[owner[ids_w] == d])
            rank_w[sw] = np.arange(len(sw))
        for d, es in enumerate(pt.elems_of):
            dofs = np.unique(space_ed[es])
            halo_ids = dofs[owner[dofs] != d]            # sorted (unique)
            is_f = np.isin(halo_ids, ids_f)
            pos = np.where(is_f, rank_f[halo_ids], Wf + rank_w[halo_ids])
            # sanity: fwd halos come from d-1, wrap halos only on ndev-1
            if np.any(is_f & (owner[halo_ids] != d - 1)):
                return False
            if np.any(~is_f & ((owner[halo_ids] != 0) | (d != ndev - 1))):
                return False
            hr[d, : len(halo_ids)] = pos
        # sender-side scatter for assemble (reverse direction): position of
        # each sent dof inside the sender's halo segment (trash -> the
        # appended zero at index H_max)
        hs_f = np.full((ndev, Wf), self.H_max, dtype=np.int64)
        hs_w = np.full((ndev, Ww), self.H_max, dtype=np.int64)
        for d, es in enumerate(pt.elems_of):
            dofs = np.unique(space_ed[es])
            halo_ids = dofs[owner[dofs] != d]
            slot = {g: i for i, g in enumerate(halo_ids)}
            # dofs this device holds as halo, grouped by destination owner
            hf = halo_ids[np.isin(halo_ids, ids_f)]       # owner d-1
            for i, g in enumerate(np.sort(hf)):
                hs_f[d, i] = slot[g]
            hw = halo_ids[np.isin(halo_ids, ids_w)]       # owner 0 (d=ndev-1)
            for i, g in enumerate(np.sort(hw)):
                hs_w[d, i] = slot[g]
        self.Wf, self.Ww = Wf, Ww
        self.tables.update({
            "gslf": self._put(gsl_f.astype(np.int32)),
            "gslw": self._put(gsl_w.astype(np.int32)),
            "hr": self._put(hr.astype(np.int32)),
            "hsf": self._put(hs_f.astype(np.int32)),
            "hsw": self._put(hs_w.astype(np.int32)),
        })
        return True

    # ---- device-side primitives (tb = per-device slice of self.tables) ----
    def _psum(self, x):
        return jax.lax.psum(x, self.axis)

    def _perm(self, kind: str):
        ndev = self.pt.ndev
        if kind == "fwd":                 # owner d -> toucher d+1
            return [(d, d + 1) for d in range(ndev - 1)]
        if kind == "fwd_rev":
            return [(d, d - 1) for d in range(1, ndev)]
        if kind == "wrap":                # owner 0 -> toucher ndev-1
            return [(0, ndev - 1)]
        return [(ndev - 1, 0)]            # wrap_rev

    def gather_halo(self, tb, x_own):
        """The received halo values [H_max] (halo-id order) for this shard —
        the owner-broadcast direction of the interface exchange."""
        if self.exchange == "ppermute":
            rf = jax.lax.ppermute(x_own[tb["gslf"]], self.axis,
                                  self._perm("fwd"))
            rw = jax.lax.ppermute(x_own[tb["gslw"]], self.axis,
                                  self._perm("wrap"))
            buf = jnp.concatenate([rf, rw, jnp.zeros(1, dtype=x_own.dtype)])
            return buf[tb["hr"]]
        buf = jnp.zeros(self.NS + 1, dtype=x_own.dtype)
        buf = buf.at[tb["oip"]].set(x_own[tb["oil"]])
        buf = self._psum(buf)
        return buf[tb["hp"]]

    def gather_loc(self, tb, x_own):
        halo = self.gather_halo(tb, x_own)
        return jnp.concatenate([x_own, halo, jnp.zeros(1, dtype=x_own.dtype)])

    def assemble_halo(self, tb, y_own, y_halo):
        """Owner-side assembly: add this shard's halo contributions
        ``y_halo [H_max]`` onto their owners and return the assembled
        ``y_own [N_max+1]`` (trash lane zeroed)."""
        if self.exchange == "ppermute":
            yh = jnp.concatenate([y_halo, jnp.zeros(1, dtype=y_own.dtype)])
            rf = jax.lax.ppermute(yh[tb["hsf"]], self.axis,
                                  self._perm("fwd_rev"))
            rw = jax.lax.ppermute(yh[tb["hsw"]], self.axis,
                                  self._perm("wrap_rev"))
            y_own = y_own.at[tb["gslf"]].add(rf).at[tb["gslw"]].add(rw)
            return y_own.at[self.N_max].set(0.0)
        buf = jnp.zeros(self.NS + 1, dtype=y_own.dtype)
        buf = buf.at[tb["hp"]].add(y_halo)
        buf = self._psum(buf)
        return y_own.at[tb["oil"]].add(buf[tb["oip"]]).at[self.N_max].set(0.0)

    def assemble_own(self, tb, y_loc):
        return self.assemble_halo(
            tb, y_loc[: self.N_max + 1],
            y_loc[self.N_max + 1: self.N_max + 1 + self.H_max])

    # ---- window (lattice-layout) E-vector transfer: no irregular gathers ----
    def _halo_plane(self, tb, x_own):
        """Exchanged window plane 0 as [1, Dy, Dx] (value irrelevant on the
        shard that owns its plane 0)."""
        w = self.win
        halo = self.gather_halo(tb, x_own)
        if halo.shape[0] >= w["plane"]:
            return halo[: w["plane"]].reshape(1, w["Dy"], w["Dx"])
        return jnp.zeros((1, w["Dy"], w["Dx"]), dtype=x_own.dtype)

    def window(self, tb, x_own):
        """Materialized local window [Dz_win, Dy, Dx]: the owned block with
        the halo plane filled into plane 0 (kept as-is on device 0)."""
        w = self.win
        x3 = x_own[: self.N_max].reshape(w["Dz_win"], w["Dy"], w["Dx"])
        p0 = self._halo_plane(tb, x_own)
        first = jnp.where(tb["ko"][0] > 0, x3[0:1], p0)
        return jnp.concatenate([first, x3[1:]], axis=0)

    def unwindow(self, tb, y3):
        """Assemble window contributions [Dz_win, Dy, Dx]: plane 0 routes to
        the lower neighbor (unless owned), the rest is the owned block."""
        w = self.win
        flat = y3.reshape(-1)
        own0 = (tb["ko"][0] > 0).astype(flat.dtype)
        p0 = flat[: w["plane"]]
        y_own = jnp.concatenate([p0 * own0, flat[w["plane"]:],
                                 jnp.zeros(1, dtype=flat.dtype)])
        y_halo = p0 * (1.0 - own0)
        if self.H_max != w["plane"]:          # single-shard partition
            y_halo = jnp.zeros(self.H_max, dtype=flat.dtype)
        return self.assemble_halo(tb, y_own, y_halo)

    def gather_E(self, tb, x_own):
        if self._lat is not None:
            return self._lat.gather(self.window(tb, x_own).reshape(-1))
        return self.gather_loc(tb, x_own)[tb["led"]]

    def assemble_E(self, tb, ye):
        if self._lat is not None:
            w = self.win
            y3 = self._lat.scatter(ye).reshape(w["Dz_win"], w["Dy"], w["Dx"])
            return self.unwindow(tb, y3)
        y_loc = jnp.zeros(self.N_max + 1 + self.H_max + 1, dtype=ye.dtype
                          ).at[tb["led"]].add(ye)
        return self.assemble_own(tb, y_loc)

    def pdot(self, a, b):
        return self._psum(jnp.dot(a, b, precision=_HI))


class ShardedLevel(ShardedExchange):
    """SPMD operator machinery for one space/operator over a Partition.

    Holds the stacked (host->device) tables and provides the per-device
    primitives used inside shard_map. Per-device table slices travel as a
    dict pytree; static sizes live on the instance.
    """

    def __init__(self, op: LaplacePA, pt: Partition,
                 ess_dofs: np.ndarray, axis: str = "shard",
                 exchange: str = "auto", put=None, ell: bool = False):
        super().__init__(pt, axis, exchange, put)
        self.op = op
        self._ell = ell
        self.Q = op.q ** 3
        self.Jr2 = op.Jr.reshape(3 * self.Q, -1)
        dtype = op.dtype
        n = op.n_dofs

        ess_mask_g = np.zeros(n)
        ess_mask_g[ess_dofs] = 1.0
        diag_c = np.where(ess_mask_g > 0, 1.0, np.asarray(op.diag))
        dstack = pt.stack_dof(diag_c, fill=1.0)
        dstack[:, pt.N_max] = 1.0
        mstack = pt.stack_dof(op.space.node_mult, fill=1.0)
        mstack[:, pt.N_max] = 1.0

        npdt = np.dtype(dtype)
        self.affine = op.C6 is not None
        if self.affine:
            # compact affine metric (see LaplacePA): 6 floats/element +
            # the quadrature-weight products, Q-fold less HBM per apply
            ndev = pt.ndev
            self.tables["C6"] = self._put(
                pt.stack_elem(np.asarray(op.C6)).astype(npdt))
            self.tables["w3"] = self._put(np.broadcast_to(
                np.asarray(op.w3).astype(npdt), (ndev, self.Q)).copy())
        else:
            self.tables["G"] = self._put(
                pt.stack_elem(np.asarray(op.G)).astype(npdt))
        self.tables.update({
            "ess": self._put(pt.stack_dof(ess_mask_g).astype(npdt)),
            "invd": self._put((1.0 / dstack).astype(npdt)),
            "invm": self._put((1.0 / mstack).astype(npdt)),
        })

        # separable apply per z-slab: engages when the operator has the
        # separable lattice form (every generated tank) AND the partition
        # uses the window layout. This is the sharded form of the
        # reference's fastest assembly mode under MPI
        # (Solvers/PF_linear_par_partial.cpp:118-124).
        self._sep = None
        if ell:
            self._init_ell()
        elif op.sep is not None and pt.win is not None \
                and not pt.win["periodic"][1]:
            self._init_sep_shard()

    def _init_ell(self) -> None:
        """Per-device PARTIAL local assembly in ELL form — the sharded twin
        of :class:`~lpfem.operators.AssembledLaplace` and of the reference's
        full-assembly-under-MPI configuration (hypre ParCSR SpMV,
        ``Solvers/PF_linear_par.cpp:114-120``). Each device assembles ONLY
        its own elements' matrices over the local dof layout
        ``[own(N_max), trash, halo(H_max), zero]`` (exactly hypre's
        diag+offd split); the apply is gather_loc -> local ELL row-sum ->
        assemble_own, so interface rows are summed across owners by the
        SAME halo exchange the matrix-free path uses."""
        op, pt = self.op, self.pt
        import scipy.sparse as sp_
        Ae = np.asarray(op.element_matrices())          # [ne, L, L]
        led = pt.local_elem_dofs                        # [ndev, E_max, L]
        L = led.shape[2]
        Nloc = self.N_max + 1 + self.H_max + 1
        csr_d = []
        kmax = 1
        for d in range(pt.ndev):
            es = pt.elems_of[d]
            ld = led[d, : len(es)].astype(np.int64)     # [E_d, L]
            rows = np.repeat(ld, L, axis=1).ravel()
            cols = np.tile(ld, (1, L)).ravel()
            A = sp_.coo_matrix((Ae[es].ravel(), (rows, cols)),
                               shape=(Nloc, Nloc)).tocsr()
            A.sum_duplicates()
            csr_d.append(A)
            kmax = max(kmax, int(np.diff(A.indptr).max()))
        cols_t = np.full((pt.ndev, Nloc, kmax), Nloc - 1, dtype=np.int32)
        vals_t = np.zeros((pt.ndev, Nloc, kmax))
        for d, A in enumerate(csr_d):
            for i in range(Nloc):
                s, e = A.indptr[i], A.indptr[i + 1]
                cols_t[d, i, : e - s] = A.indices[s:e]
                vals_t[d, i, : e - s] = A.data[s:e]
        npdt = np.dtype(op.dtype)
        self.tables["ellc"] = self._put(cols_t)
        self.tables["ellv"] = self._put(vals_t.astype(npdt))

    def _ell_apply_own(self, tb, x_own):
        x_loc = self.gather_loc(tb, x_own)              # [Nloc]
        y_loc = jnp.sum(tb["ellv"] * x_loc[tb["ellc"]], axis=1)
        return self.assemble_own(tb, y_loc)

    def _init_sep_shard(self) -> None:
        """Per-device z bands of the window: the slab's own element layers
        (x/y bands are global — slabs cut z only), zero-width padded layers
        on devices with fewer layers. Each device applies the bands to its
        window; the shared plane 0 routes to the lower neighbour through
        :meth:`unwindow`, as on the element path."""
        from .elements import basis_1d
        from .operators import band_1d
        op, w = self.op, self.pt.win
        sep = op.sep
        hz = np.asarray(sep.spacings[2], np.float64)
        basis = basis_1d(op.p, op.q)
        nez_loc = w["dims"][2]
        kz, mz = [], []
        for d in range(self.pt.ndev):
            s0, nl = int(w["ez0"][d]), int(w["nlay"][d])
            hs = np.zeros(nez_loc)
            hs[:nl] = hz[s0:s0 + nl]
            kz.append(band_1d(hs, basis, False, True))
            mz.append(band_1d(hs, basis, False, False))
        npdt = np.dtype(op.dtype)
        self.tables["sep_kz"] = self._put(np.stack(kz).astype(npdt))
        self.tables["sep_mz"] = self._put(np.stack(mz).astype(npdt))
        self._sep = (sep.Kx, sep.Mx, sep.Ky, sep.My, bool(sep.periodic[0]))

    def _sep_apply_own(self, tb, x_own):
        from .operators import sep_apply3
        Kx, Mx, Ky, My, px = self._sep
        u = self.window(tb, x_own)
        y3 = sep_apply3(u, (Kx, Mx, Ky, My, tb["sep_kz"], tb["sep_mz"]), px)
        return self.unwindow(tb, y3)

    def apply_own(self, tb, x_own):
        """A x on owned lanes (no BC)."""
        if self._ell:
            return self._ell_apply_own(tb, x_own)
        if self._sep is not None:
            return self._sep_apply_own(tb, x_own)
        prec = self.op._prec
        u = self.gather_E(tb, x_own)
        g = jnp.einsum("gl,el->eg", self.Jr2, u,
                       precision=prec).reshape(-1, 3, self.Q)
        if self.affine:
            h = _apply_G6_affine(tb["C6"], tb["w3"],
                                 g[:, 0], g[:, 1], g[:, 2])
        else:
            h = _apply_G6(tb["G"], g[:, 0], g[:, 1], g[:, 2])
        ye = jnp.einsum("gl,eg->el", self.Jr2, h.reshape(h.shape[0], -1),
                        precision=prec)
        return self.assemble_E(tb, ye)

    def apply_c(self, tb, x_own):
        """Constrained apply: identity on essential lanes."""
        free = 1.0 - tb["ess"]
        y = self.apply_own(tb, x_own * free)
        return y * free + x_own * tb["ess"]


class _ShardedChebyshev:
    """Per-device Chebyshev-Jacobi smoother over a ShardedLevel."""

    def __init__(self, level: ShardedLevel, lmax: float, degree: int = 3,
                 lmin_frac: float = 1.0 / 30.0):
        self.level = level
        self.degree = degree
        lmin = lmin_frac * lmax
        self.theta = (lmax + lmin) / 2.0
        self.delta = (lmax - lmin) / 2.0

    def __call__(self, tb, r, z0=None):
        lv = self.level
        invD = tb["invd"]
        if z0 is None:
            res = r
            z = jnp.zeros_like(r)
        else:
            z = z0
            res = r - lv.apply_c(tb, z)
        sigma = self.theta / self.delta
        rho = 1.0 / sigma
        d = invD * res / self.theta
        z = z + d
        for _ in range(self.degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho * d
                 + (2.0 * rho_new / self.delta) * (invD * (r - lv.apply_c(tb, z))))
            z = z + d
            rho = rho_new
        return z


class _ShardedTransfer:
    """Embedded-interpolation transfer between consecutive sharded levels.

    For p-coarsening the fine-side E-vector exchange is the fine level
    itself (``via=None``). For h-coarsening below p=1 the fine side rides a
    helper p=2 exchange on the half mesh whose dof layout is IDENTICAL to
    the fine level's (ownership inherited through the Partition ``owner``
    override), so no re-layout communication is needed — same trick as the
    single-device ``lpfem.multigrid._Transfer``.
    """

    def __init__(self, I3, fine: ShardedLevel, coarse: ShardedLevel,
                 via: ShardedExchange | None = None):
        self.I3 = I3
        self.fine = fine
        self.coarse = coarse
        self.via = via

    def _via(self, tbf, vtb):
        return (self.fine, tbf) if self.via is None else (self.via, vtb)

    def prolong(self, tbf, tbc, vtb, xc):
        via, tbv = self._via(tbf, vtb)
        uc = self.coarse.gather_E(tbc, xc)
        uf = jnp.einsum("fc,ec->ef", self.I3, uc, precision=_HI)
        xf = via.assemble_E(tbv, uf) * tbv["invm"]
        return xf * (1.0 - tbf["ess"])

    def restrict(self, tbf, tbc, vtb, rf):
        via, tbv = self._via(tbf, vtb)
        uf = via.gather_E(tbv, rf * tbv["invm"])
        uc = jnp.einsum("fc,ef->ec", self.I3, uf, precision=_HI)
        rc = self.coarse.assemble_E(tbc, uc)
        return rc * (1.0 - tbc["ess"])


def _estimate_lmax_sharded(lv: "ShardedLevel", device_mesh: Mesh,
                           iters: int = 20, safety: float = 1.1) -> float:
    """Power-iteration estimate of lambda_max(D^-1 A) through the SHARDED
    operator: one shard_map'd step, iterated from the host. No full-size
    vector or apply ever exists on a single device."""
    sh, rep = P("shard"), P()

    def step(v, tb):
        tb = jax.tree.map(lambda a: a[0], tb)
        w = lv.apply_c(tb, v[0]) * tb["invd"]
        lam = jnp.sqrt(lv.pdot(w, w))
        return (w / lam)[None], lam

    fn = jax.jit(jax.shard_map(step, mesh=device_mesh, in_specs=(sh, sh),
                               out_specs=(sh, rep), check_vma=False))
    rng = np.random.default_rng(0)
    v0 = lv.pt.stack_dof(
        rng.standard_normal(len(lv.pt.owner)).astype(np.dtype(lv.op.dtype)))
    v = lv._put(v0)
    lam = 1.0
    for _ in range(iters):
        v, lam = fn(v, lv.tables)
    return float(lam) * safety


class ShardedPMG:
    """Sharded multigrid V-cycle: p-coarsening levels over one element
    partition, then h-coarsening below p=1 on per-level partitions derived
    from the fine slabs (see lpfem.multigrid for the single-device variant
    and the SPD-consistency argument). Matches the fully parallel role of
    the reference's BoomerAMG (``Solvers/laplace_solver_parallel.cpp:134-146``)."""

    def __init__(self, prob: Problem, pt_fine: Partition, ndev: int,
                 smooth_degree: int = 3, coarse_cheb_degree: int = 16,
                 h_coarsen_min_dofs: int = 20000, exchange: str = "auto",
                 put=None, device_mesh: Mesh | None = None,
                 lmax_mode: str = "host"):
        from .multigrid import (_coarsen_structured_mesh, _interp_1d,
                                _top_plane_dofs, estimate_lmax)
        from .params import BigParams
        from .space import H1Space

        space = prob.space
        mesh = space.mesh
        p = space.p
        dtype = prob.op.dtype
        orders = []
        q = p
        while q > 1:
            orders.append(q)
            q = max(1, q // 2)
        orders.append(1)
        self.orders = orders

        def _I3(pc, pf):
            I1 = _interp_1d(pc, pf)
            return jnp.asarray(
                np.einsum("cz,by,ax->cbazyx", I1, I1, I1).reshape(
                    (pf + 1) ** 3, (pc + 1) ** 3), dtype=dtype)

        self.levels: list[ShardedLevel] = []
        self.transfers: list[_ShardedTransfer] = []
        ess_fine = np.asarray(prob.surf.surf_to_vol)
        self.ess_list = []
        for li, pl in enumerate(orders):
            if li == 0:
                op = prob.op
                pt = pt_fine
                ess = ess_fine
            else:
                sp = H1Space(mesh, pl)
                op = LaplacePA(sp, dtype=dtype, mode="fused",
                               precision=prob.op.precision)
                pt = Partition(sp, ndev, part=pt_fine.part)
                ess = sp.boundary_dofs(2)
            self.levels.append(ShardedLevel(op, pt, ess, exchange=exchange,
                                            put=put))
            self.ess_list.append(ess)
            if li > 0:
                self.transfers.append(_ShardedTransfer(
                    _I3(orders[li], orders[li - 1]),
                    self.levels[-2], self.levels[-1]))

        # ---- h-coarsening below p=1 (structured tank meshes), sharded ----
        while True:
            bot = self.levels[-1]
            sp_b = bot.op.space
            if (sp_b.p != 1 or sp_b.struct is None
                    or bot.op.n_dofs <= h_coarsen_min_dofs):
                break
            if not np.array_equal(np.sort(np.asarray(self.ess_list[-1])),
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
            # coarse slab partition descends from the bottom level's: parent
            # element -> device of its (0,0,0) child
            nex, ney, nez = sp_b.struct.elem_dims
            pf3 = np.asarray(bot.pt.part).reshape(nez, ney, nex)
            part_c = np.ascontiguousarray(pf3[::2, ::2, ::2]).reshape(-1)
            # 'via' layout: inherits the bottom level's dof layout. With the
            # window (lattice) layout this requires the coarse z-slabs to
            # halve the fine slabs exactly; otherwise stop h-coarsening here
            # (mixing layouts between bot and via would corrupt transfers).
            lat_loc = None
            if bot.pt.win is not None:
                bw = bot.pt.win
                sl_c = _zslab_layers(part_c, hs.struct.elem_dims, ndev)
                ok = (sl_c is not None
                      and np.array_equal(bw["p"] * np.asarray(bw["ez0"]),
                                         2 * sl_c[0])
                      and np.array_equal(bw["p"] * np.asarray(bw["nlay"]),
                                         2 * sl_c[1]))
                if not ok:
                    # coarse slabs no longer halve the fine slabs: rebuild
                    # the bottom level with the compact layout (cheap at
                    # p=1) so h-coarsening can continue below it
                    pt_b = Partition(sp_b, ndev, part=bot.pt.part,
                                     layout="compact")
                    bot = ShardedLevel(bot.op, pt_b, self.ess_list[-1],
                                       exchange=exchange, put=put)
                    self.levels[-1] = bot
                    self.transfers[-1].coarse = bot
            if bot.pt.win is not None:
                bw = bot.pt.win
                nex_c, ney_c, nez_c = hs.struct.elem_dims
                win_via = {
                    "p": 2, "dims": (nex_c, ney_c, int(sl_c[1].max())),
                    "ez0": sl_c[0], "nlay": sl_c[1],
                    "Dx": bw["Dx"], "Dy": bw["Dy"], "Dz_win": bw["Dz_win"],
                    "plane": bw["plane"], "periodic": bw["periodic"],
                }
                assert 2 * int(sl_c[1].max()) + 1 == bw["Dz_win"]
                lat_loc = (bot.pt.loc_of_dof, bot.pt.N_max, win_via)
            pt_c = Partition(sp_c, ndev, part=part_c)
            op_c = LaplacePA(sp_c, dtype=dtype, mode="fused",
                             precision=prob.op.precision)
            ess_c = _top_plane_dofs(sp_c.struct)
            lvl_c = ShardedLevel(op_c, pt_c, ess_c, exchange=exchange,
                                 put=put)
            # 'via' p=2 exchange on the half mesh, dof layout inherited from
            # the bottom level (identical global lattice numbering)
            pt_via = Partition(hs, ndev, part=part_c, owner=bot.pt.owner,
                               lat_loc=lat_loc,
                               layout="compact" if lat_loc is None else "auto")
            assert pt_via.N_max == bot.pt.N_max
            via = ShardedExchange(pt_via, put=put)
            mstack = pt_via.stack_dof(np.asarray(hs.node_mult, dtype=np.float64),
                                      fill=1.0)
            mstack[:, pt_via.N_max] = 1.0
            via.tables["invm"] = via._put((1.0 / mstack).astype(np.dtype(dtype)))
            self.transfers.append(_ShardedTransfer(_I3(1, 2), bot, lvl_c,
                                                   via=via))
            self.levels.append(lvl_c)
            self.ess_list.append(ess_c)
            self.orders = self.orders + [1]

        # eigenvalue estimates. lmax_mode='host': on the single-device
        # operators (same spectra), with big buffers threaded as jit
        # arguments (lpfem.params) — the compile-payload cap applies here
        # too. lmax_mode='sharded': power-iterate the SHARDED operator over
        # the device mesh, so setup never runs a full-size apply on one
        # device (the decentralized-setup path).
        self.lmax = []
        if lmax_mode == "sharded":
            assert device_mesh is not None
            for lv in self.levels:
                self.lmax.append(_estimate_lmax_sharded(lv, device_mesh))
        else:
            for lv, ess in zip(self.levels, self.ess_list):
                op = lv.op
                essj = jnp.asarray(np.asarray(ess).astype(np.int32))
                inv_diag = 1.0 / op.diag.at[essj].set(1.0)
                bp = BigParams()
                op.register_params(bp)
                self.lmax.append(estimate_lmax(
                    lambda v: op.constrained_apply(v, essj), inv_diag,
                    op.n_dofs, dtype=op.dtype, params=bp))
        self.smoothers = [
            _ShardedChebyshev(lv, lm, degree=smooth_degree)
            for lv, lm in zip(self.levels, self.lmax)]
        self.smoothers[-1] = _ShardedChebyshev(
            self.levels[-1], self.lmax[-1], degree=coarse_cheb_degree)

    def all_tables(self):
        """The stacked tables of every level and every transfer-via exchange
        as one pytree (for shard_map)."""
        return {"lv": [lv.tables for lv in self.levels],
                "via": [None if tr.via is None else tr.via.tables
                        for tr in self.transfers]}

    # device-side ---------------------------------------------------------
    def vcycle(self, tbs, r, li=0):
        lv = self.levels[li]
        sm = self.smoothers[li]
        if li == len(self.levels) - 1:
            return sm(tbs["lv"][li], r)
        z = sm(tbs["lv"][li], r)
        tr = self.transfers[li]
        args = (tbs["lv"][li], tbs["lv"][li + 1], tbs["via"][li])
        rc = tr.restrict(*args, r - lv.apply_c(tbs["lv"][li], z))
        zc = self.vcycle(tbs, rc, li + 1)
        z = z + tr.prolong(*args, zc)
        return sm(tbs["lv"][li], r, z0=z)


class ShardedProblem:
    """SPMD form of :class:`~lpfem.problem.Problem` over a device mesh axis.

    The surface state is replicated; the volume potential and all element
    data are sharded. ``run`` executes the full RK4 loop (with the CG solve
    and, when configured, the p-multigrid V-cycle) inside a single
    ``shard_map``-ed jit.
    """

    def __init__(self, prob: Problem, mesh: Mesh | None = None,
                 n_dev: int | None = None, place: bool = True,
                 lmax_mode: str = "host"):
        """``place=True`` (default) device_puts every [ndev, ...] table with
        a leading-axis NamedSharding, so each device only ever holds its own
        slice. ``lmax_mode='sharded'`` estimates smoother eigenvalues through
        the sharded operator (see :func:`_estimate_lmax_sharded`)."""
        self.prob = prob
        # apply_mode="assembled": drive the CG through a per-device partial
        # local assembly (ELL SpMV + halo assemble) — the reference's
        # full-assembly-under-MPI configuration (PF_linear_par.cpp:114-120)
        ell = getattr(prob, "op_solve", None) is not None
        self.mesh = mesh if mesh is not None else make_device_mesh(n_dev)
        ndev = self.mesh.devices.size
        self.ndev = ndev
        op = prob.op
        sp = prob.space
        pt = Partition(sp, ndev)
        self.pt = pt
        # state dtype (f64 when the problem is mixed-precision; == op.dtype
        # otherwise) — the operator tables keep op.dtype
        self.dtype = prob.dtype
        put = sharded_put(self.mesh) if place else jnp.asarray
        self._table_put = put

        ess_fine = np.asarray(prob.surf.surf_to_vol)
        exchange = getattr(prob.cfg, "shard_exchange", "auto")
        self.fine = ShardedLevel(op, pt, ess_fine, exchange=exchange, put=put,
                                 ell=ell)
        # mixed precision (Problem dtype="mixed"): a second f64 level powers
        # the outer residuals of pcg_ir while self.fine (f32) runs the inner
        # CG + preconditioner — the SPMD form of the single-device mixed path
        self.fine_hi = None
        if getattr(prob, "op_hi", None) is not None:
            self.fine_hi = ShardedLevel(prob.op_hi, pt, ess_fine,
                                        exchange=exchange, put=put)
        self.N_max = pt.N_max

        self.pmg = None
        if prob.cfg.precond == "pmg" and sp.p > 1:
            self.pmg = ShardedPMG(prob, pt, ndev,
                                  smooth_degree=prob.cfg.cheb_degree,
                                  h_coarsen_min_dofs=prob.cfg.h_coarsen_min_dofs,
                                  exchange=exchange, put=put,
                                  device_mesh=self.mesh, lmax_mode=lmax_mode)

        # ---- z-derivative tables (compact affine metric when available:
        # 3 floats/element instead of 3 per node, see NodalZDerivative) ----
        zd = prob.fso.zderiv
        npdt = np.dtype(self.dtype)
        self._zd_affine = zd.Jz3 is not None
        zsrc = zd.Jz3 if self._zd_affine else zd.Jinv_z
        self.Jinv_z = put(pt.stack_elem(np.asarray(zsrc)).astype(npdt))
        self.Dn = zd.Dn
        self.p1 = sp.p + 1

        # ---- surface <-> volume (surface state replicated) ----
        s2v = ess_fine
        NSurf = len(s2v)
        self.NSurf = NSurf
        sp_owner = pt.owner[s2v]
        NSo = max(int(np.max(np.bincount(sp_owner, minlength=ndev))), 1)
        spos = np.full((ndev, NSo), NSurf, dtype=np.int64)
        sloc = np.full((ndev, NSo), pt.N_max, dtype=np.int64)
        for d in range(ndev):
            sel = np.where(sp_owner == d)[0]
            spos[d, : len(sel)] = sel
            sloc[d, : len(sel)] = pt.loc_of_dof[s2v[sel]]
        self.surf_pos = put(spos.astype(np.int32))
        self.surf_loc = put(sloc.astype(np.int32))

    @classmethod
    def from_config(cls, cfg, mesh: "Mesh | None" = None,
                    device_mesh: Mesh | None = None, problem_mesh=None):
        """Decentralized setup: build the problem WITHOUT materializing any
        full-size array on an accelerator device.

        All setup compute (geometric factors, operator diagonals, dof
        numbering) runs on the host CPU backend; the per-shard tables are
        then placed directly onto their devices (``sharded_put``), and the
        smoother eigenvalue estimates power-iterate the sharded operator on
        the device mesh. Peak per-device setup memory is O(N/ndev) — the
        domain-decomposition contract of the reference's ParMesh/hypre
        stack (``Solvers/laplace_solver_parallel.cpp:76-78``), which the
        wrap-a-single-device-Problem path cannot honor beyond one device's
        memory.
        """
        dm = device_mesh if device_mesh is not None else mesh
        if dm is None:
            dm = make_device_mesh()
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            prob = Problem(cfg, mesh=problem_mesh, build_precond=False)
            sprob = cls(prob, mesh=dm, place=True, lmax_mode="sharded")
        return sprob

    # ---------------------------------------------------------- device rhs
    def _zderiv_own(self, tb, jinv_z, phi_own):
        lv = self.fine
        p1 = self.p1
        u = lv.gather_E(tb, phi_own).reshape(-1, p1, p1, p1)
        Bn = jnp.eye(p1, dtype=phi_own.dtype)
        Dn = self.Dn
        ne = u.shape[0]

        def t3(v, Az, Ay, Ax):
            return jnp.einsum("cz,by,ax,ezyx->ecba", Az, Ay, Ax, v,
                              precision=_HI)

        gx = t3(u, Bn, Bn, Dn).reshape(ne, p1 ** 3)
        gy = t3(u, Bn, Dn, Bn).reshape(ne, p1 ** 3)
        gz = t3(u, Dn, Bn, Bn).reshape(ne, p1 ** 3)
        if self._zd_affine:
            w_e = (jinv_z[:, 0:1] * gx + jinv_z[:, 1:2] * gy
                   + jinv_z[:, 2:3] * gz)
        else:
            ghat = jnp.stack([gx, gy, gz], axis=-1)
            w_e = jnp.einsum("eli,eli->el", jinv_z, ghat, precision=_HI)
        return lv.assemble_E(tb, w_e) * tb["invm"]

    def _make_spmd_rhs(self):
        prob = self.prob
        fso = prob.fso
        NSurf = self.NSurf
        g_const = fso.g
        relax = fso.relax
        rtol_sq, max_iter = fso.cg_rtol_sq, fso.cg_max_iter
        lv = self.fine
        lv_hi = self.fine_hi
        pmg = self.pmg

        def rhs(t, y, aux, tb, tb_hi, pmg_tbs, jinv_z, surf_pos,
                surf_loc):
            phi_own, stats = aux
            eta, phi_fs = y[:NSurf], y[NSurf:]
            free = 1.0 - tb["ess"]

            pfs_pad = jnp.concatenate([phi_fs, jnp.zeros(1, dtype=phi_fs.dtype)])
            x_bc = jnp.zeros(self.N_max + 1, dtype=phi_fs.dtype
                             ).at[surf_loc].set(pfs_pad[surf_pos])

            if pmg is not None:
                precond = lambda r: pmg.vcycle(pmg_tbs, r)
            else:
                precond = lambda r: r * tb["invd"]

            if lv_hi is not None:
                # mixed: f64 constrained system + outer residuals through
                # the hi level; inner f32 CG + preconditioner via pcg_ir
                B = -lv_hi.apply_own(tb_hi, x_bc) * free + x_bc
                x0 = phi_own * free + x_bc
                res = pcg_ir(lambda v: lv_hi.apply_c(tb_hi, v),
                             lambda v: lv.apply_c(tb, v), B, x0,
                             precond_lo=precond,
                             rtol_sq=rtol_sq, atol_sq=fso.cg_atol_sq,
                             max_outer=fso.ir_max_outer,
                             inner_rtol_sq=fso.ir_inner_rtol_sq,
                             inner_max_iter=max_iter, dot_fn=lv.pdot)
            else:
                B = -lv.apply_own(tb, x_bc) * free + x_bc
                x0 = phi_own * free + x_bc
                res = pcg(lambda v: lv.apply_c(tb, v), B, x0,
                          precond_fn=precond,
                          rtol_sq=rtol_sq, max_iter=max_iter, dot_fn=lv.pdot)
            phi_new = res.x

            # the z-derivative reads the hi tables when mixed (f64 invm)
            w_own = self._zderiv_own(tb_hi if lv_hi is not None else tb,
                                     jinv_z, phi_new)
            sbuf = jnp.zeros(NSurf + 1, dtype=phi_fs.dtype
                             ).at[surf_pos].set(w_own[surf_loc])
            sbuf = lv._psum(sbuf)
            w_tilde = sbuf[:NSurf]

            deta = w_tilde
            dpfs = -g_const * eta
            if relax is not None:
                eta_e, phi_e = relax.targets(t)
                alpha_gen = jnp.clip(t / (relax.n_ramp * relax.T), 0.0, 1.0)
                inv_tau = 1.0 / relax.tau
                gen_w = alpha_gen * relax.cgen * inv_tau
                deta = deta + gen_w * (eta_e - eta) - relax.cabs * inv_tau * eta
                dpfs = dpfs + gen_w * (phi_e - phi_fs) - relax.cabs * inv_tau * phi_fs
            # convergence telemetry — same semantics as the single-device
            # FreeSurfaceOperator._info (dots are psum'd, so the verdict is
            # SPMD-consistent across shards)
            from .surface import SolveInfo
            threshold = jnp.maximum(res.rz0 * rtol_sq, fso.cg_atol_sq)
            stats = stats.update(SolveInfo(
                iters=res.iters, converged=res.rz <= threshold,
                rz=res.rz, rz0=res.rz0))
            return jnp.concatenate([deta, dpfs]), (phi_new, stats)

        return rhs

    # ------------------------------------------------------------------ API
    def run(self, n_steps: int | None = None, t0: float = 0.0, state=None,
            record=None):
        """Full sharded RK4 run. Returns (t, y_replicated, phi_stacked) —
        or ((t, y, phi), outs) when ``record`` is given.

        ``record(t, y, aux)`` — with ``aux = (phi_own, stats)`` — runs per
        device inside the scan with the
        REPLICATED surface state ``y`` (and this device's volume slice), so
        surface-trajectory records — error histories, the diffraction
        envelope — come out identical to the single-device ``Problem.run``
        hook; its stacked per-step outputs return replicated. This is the
        SPMD analogue of the reference gathering per-step outputs under MPI
        (``Solvers/cylinder-diffraction.cpp:537-560``,
        ``Convergence_and_Scaling/convergence-parallel.cpp:269-276``).

        Compiled programs are cached per (n_steps, record); ``t0`` is a
        traced argument so chunked long runs reuse one executable (same as
        ``Problem.run``)."""
        prob = self.prob
        if n_steps is None:
            n_steps = prob.cfg.nsteps
        if state is None:
            y0, phi0_g = prob.initial_state(t0)
        else:
            y0, phi0_g = state
        if np.ndim(phi0_g) == 2:
            phi0 = (phi0_g if isinstance(phi0_g, jax.Array)
                    else self._table_put(np.asarray(phi0_g, dtype=self.dtype)))
        else:
            phi0 = self._table_put(
                self.pt.stack_dof(np.asarray(phi0_g)).astype(
                    np.dtype(self.dtype)))
        t0 = jnp.asarray(t0, dtype=self.dtype)
        if not hasattr(self, "_compiled"):
            self._compiled = {}
        key = (n_steps, record)
        if key in self._compiled:
            return self._compiled[key](t0, y0, phi0)

        rhs = self._make_spmd_rhs()
        dt = prob.dt
        pmg_tables = (self.pmg.all_tables() if self.pmg is not None
                      else {"lv": [], "via": []})
        hi_tables = (self.fine_hi.tables if self.fine_hi is not None
                     else {})

        def device_fn(t0, y0, phi0, tb, tb_hi, pmg_tbs, jinv_z, surf_pos,
                      surf_loc):
            # shard_map keeps rank: drop the leading size-1 device axis
            (phi0, jinv_z, surf_pos, surf_loc) = (
                a[0] for a in (phi0, jinv_z, surf_pos, surf_loc))
            tb = jax.tree.map(lambda a: a[0], tb)
            tb_hi = jax.tree.map(lambda a: a[0], tb_hi)
            pmg_tbs = jax.tree.map(lambda a: a[0], pmg_tbs)

            def f(t, y, aux):
                return rhs(t, y, aux, tb, tb_hi, pmg_tbs, jinv_z,
                           surf_pos, surf_loc)

            # one shard's NaN must freeze every shard in the same step
            ndev = self.ndev
            g_red = lambda fin: self.fine._psum(fin.astype(jnp.int32)) == ndev
            from .surface import SolveStats
            aux0 = (phi0, SolveStats.zero())
            (t, y, (phi, stats)), outs, ok = rk4_run(
                f, y0, aux0, t0, dt, n_steps, record=record,
                guard_reduce=g_red)
            return t, y, phi[None], stats, outs, ok

        sh, rep = P("shard"), P()
        fn = jax.shard_map(
            device_fn, mesh=self.mesh,
            in_specs=(rep, rep, sh, sh, sh, sh, sh, sh, sh),
            out_specs=(rep, rep, sh, rep, rep, rep),
            check_vma=False,
        )
        fn = jax.jit(fn)

        def call(t0, y0, phi0):
            t, y, phi, stats, outs, ok = fn(t0, y0, phi0, self.fine.tables,
                                            hi_tables, pmg_tables,
                                            self.Jinv_z,
                                            self.surf_pos, self.surf_loc)
            self._last_ok = ok
            self.last_solver_stats = stats
            if bool(stats.unconverged):
                import warnings
                warnings.warn(
                    "Laplace CG did not converge in at least one RK4 stage "
                    f"(worst solve: {int(stats.max_iters)} iterations)",
                    RuntimeWarning, stacklevel=2)
            if record is not None:
                return (t, y, phi), outs
            return t, y, phi

        self._compiled[key] = call
        return call(t0, y0, phi0)

    def phi_global(self, phi_stacked) -> np.ndarray:
        return self.pt.unstack_dof(np.asarray(phi_stacked))
