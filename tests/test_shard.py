"""Sharded (multi-device) correctness: shard-count invariance.

The reference validates parallel correctness by identical analytic errors
under ``mpirun -np {1..8}`` (SURVEY.md §4); here the same property is
asserted on a virtual 8-device CPU mesh: the sharded run must reproduce the
single-device run to solver tolerance.
"""

import jax
import numpy as np
import pytest

from lpfem.configs import preset
from lpfem.problem import Problem
from lpfem.shard import Partition, ShardedProblem, make_device_mesh
from lpfem.space import H1Space


def test_partition_tables():
    cfg = preset("pf_linear_periodic", nx=8, nz=2, order=3)
    prob = Problem(cfg)
    pt = Partition(prob.space, 4)
    assert pt.n_own.sum() == prob.space.n_dofs
    # every element assigned exactly once
    assert sum(len(e) for e in pt.elems_of) == prob.mesh.n_elems
    # stack/unstack roundtrip
    v = np.random.default_rng(0).standard_normal(prob.space.n_dofs)
    assert np.allclose(pt.unstack_dof(pt.stack_dof(v)), v)
    # interface dofs: on this periodic tank each slab boundary is a yz-plane
    assert pt.NS > 0


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_matches_single_device(ndev):
    assert len(jax.devices()) >= ndev, "conftest must force 8 CPU devices"
    cfg = preset("pf_linear_periodic", nx=8, nz=2, order=3, nsteps=5,
                 cg_max_iter=600)
    prob = Problem(cfg)
    (t1, y1, phi1), _ = prob.run(n_steps=5)

    sprob = ShardedProblem(prob, mesh=make_device_mesh(ndev))
    t2, y2, phi2 = sprob.run(n_steps=5)

    assert np.isclose(float(t1), float(t2))
    err = np.max(np.abs(np.asarray(y1) - np.asarray(y2)))
    scale = np.max(np.abs(np.asarray(y1)))
    # identical math up to CG tolerance / reduction-order round-off
    assert err < 1e-10 * max(scale, 1.0), (err, scale)
    # volume potential agrees too
    phi2g = sprob.phi_global(phi2)
    assert np.max(np.abs(np.asarray(phi1) - phi2g)) < 1e-10


def test_lattice_window_layout_partition():
    """z-slab window layout engages on structured meshes with nez >= ndev:
    each shard's owned block is its local sub-lattice (plane 0 = halo slot),
    so the sharded hot path needs no irregular gathers."""
    cfg = preset("scaling_base", nx=4, ny=2, nz=8, order=2)
    prob = Problem(cfg)
    pt = Partition(prob.space, 4)
    assert pt.win is not None
    assert pt.n_own.sum() == prob.space.n_dofs
    v = np.random.default_rng(0).standard_normal(prob.space.n_dofs)
    assert np.allclose(pt.unstack_dof(pt.stack_dof(v)), v)
    # device 0 owns its plane 0; everyone else's window plane 0 is halo
    assert pt.win["ez0"][0] == 0 and pt.win["nlay"][0] == max(pt.win["nlay"])


@pytest.mark.parametrize("ndev,mesh_kind", [(4, "periodic_tank"),
                                            (3, "periodic_tank"),
                                            (4, "finite_tank")])
def test_sharded_fused_kernel_matches_reference(ndev, mesh_kind):
    """The per-shard separable apply (f32, z-slab window layout) through the
    full sharded exchange vs the f64 reference operator — both the plain
    and the constrained apply. ndev=3 exercises padded slabs (zero-width
    layers in the per-device z bands). Matches the reference running its
    fastest assembly mode under MPI
    (Solvers/PF_linear_par_partial.cpp:118-124)."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from lpfem.operators import LaplacePA
    from lpfem.shard import ShardedLevel

    cfg = preset("scaling_base", nx=4, ny=2, nz=8, order=3,
                 mesh_kind=mesh_kind)
    prob = Problem(cfg)                      # f64 reference
    sp = prob.space
    ess = np.asarray(prob.surf.surf_to_vol)
    essj = jnp.asarray(ess.astype(np.int32))
    x = np.random.default_rng(2).standard_normal(sp.n_dofs)
    y_ref_c = np.asarray(prob.op.constrained_apply(jnp.asarray(x), essj))
    y_ref = np.asarray(prob.op.apply(jnp.asarray(x)))

    op32 = LaplacePA(sp, dtype=jnp.float32, mode="fused")
    assert op32.sep is not None
    pt = Partition(sp, ndev)
    assert pt.win is not None
    lv = ShardedLevel(op32, pt, ess)
    assert lv._sep is not None, "window layout fell back to the gather path"

    mesh = make_device_mesh(ndev)
    x_st = jnp.asarray(pt.stack_dof(x).astype(np.float32))

    def dev_fn(x_st, tb):
        tb = jax.tree.map(lambda a: a[0], tb)
        yc = lv.apply_c(tb, x_st[0])
        yo = lv.apply_own(tb, x_st[0])
        return yc[None], yo[None]

    fn = jax.jit(jax.shard_map(dev_fn, mesh=mesh,
                               in_specs=(P("shard"), P("shard")),
                               out_specs=(P("shard"), P("shard")),
                               check_vma=False))
    yc_st, yo_st = fn(x_st, lv.tables)
    scale = np.max(np.abs(y_ref_c))
    err_c = np.max(np.abs(pt.unstack_dof(np.asarray(yc_st)) - y_ref_c))
    err_o = np.max(np.abs(pt.unstack_dof(np.asarray(yo_st)) - y_ref))
    assert err_c < 5e-5 * scale, err_c / scale
    assert err_o < 5e-5 * np.max(np.abs(y_ref)), err_o


def test_sharded_zslab_pmg_trajectory_matches_single_device():
    """Full RK4 trajectory with pmg on a z-slab window-layout partition
    (lattice E-vector paths + window transfers + compact fallback below the
    slab resolution) vs the single-device run."""
    cfg = preset("scaling_base", nx=4, ny=2, nz=8, order=2, nsteps=5,
                 precond="pmg", cg_rtol_sq=1e-24, cg_max_iter=400)
    prob = Problem(cfg)
    (t1, y1, phi1), _ = prob.run(n_steps=5)
    sprob = ShardedProblem(prob, mesh=make_device_mesh(4))
    assert sprob.pt.win is not None
    t2, y2, phi2 = sprob.run(n_steps=5)
    err = np.max(np.abs(np.asarray(y1) - np.asarray(y2)))
    scale = np.max(np.abs(np.asarray(y1)))
    assert err < 1e-10 * max(scale, 1.0), (err, scale)
    phi2g = sprob.phi_global(phi2)
    assert np.max(np.abs(np.asarray(phi1) - phi2g)) < 1e-10


def test_sharded_relaxation_tank():
    """Finite tank with relaxation zones, sharded vs single device."""
    # keep the flagship's dt = 5T/180 when shortening the run
    cfg = preset("pf_linear_par_partial", nsteps=5, t_final_periods=5 * 5 / 180,
                 order=2, cg_max_iter=600)
    prob = Problem(cfg)
    y0, phi0 = prob.zero_state()
    (t1, y1, _), _ = prob.run(n_steps=5, state=(y0, phi0))
    sprob = ShardedProblem(prob, mesh=make_device_mesh(4))
    t2, y2, _ = sprob.run(n_steps=5, state=(y0, phi0))
    err = np.max(np.abs(np.asarray(y1) - np.asarray(y2)))
    scale = max(float(np.max(np.abs(np.asarray(y1)))), 1e-30)
    assert err < 1e-11 * scale, (err, scale)


def test_sharded_pmg_h_coarsening_matches_single_device():
    """The sharded V-cycle with h-levels below p=1 must equal the
    single-device PMultigrid V-cycle (same hierarchy, same smoothers) —
    the fully-parallel-preconditioner analogue of BoomerAMG
    (reference Solvers/laplace_solver_parallel.cpp:134-146)."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from lpfem.multigrid import PMultigrid
    from lpfem.shard import ShardedPMG

    ndev = 4
    cfg = preset("pf_linear_periodic", nx=8, ny=2, nz=4, order=2,
                 cg_max_iter=300)
    prob = Problem(cfg)
    pt = Partition(prob.space, ndev)
    spmg = ShardedPMG(prob, pt, ndev, h_coarsen_min_dofs=0)
    assert len(spmg.levels) > 2, "h-coarsening below p=1 did not engage"

    ess = np.asarray(prob.surf.surf_to_vol)
    ref = PMultigrid(prob.op, ess_dofs=ess, coarse_dense_limit=0,
                     h_coarsen_min_dofs=0)
    assert len(ref.levels) == len(spmg.levels)

    rng = np.random.default_rng(3)
    r = rng.standard_normal(prob.space.n_dofs)
    r[ess] = 0.0
    z_ref = np.asarray(ref(jnp.asarray(r)))

    mesh = make_device_mesh(ndev)
    tbs = spmg.all_tables()
    r_st = jnp.asarray(pt.stack_dof(r))

    def dev_fn(r_st, tbs):
        tbs = jax.tree.map(lambda a: a[0], tbs)
        return spmg.vcycle(tbs, r_st[0])[None]

    fn = jax.jit(jax.shard_map(dev_fn, mesh=mesh,
                               in_specs=(P("shard"), P("shard")),
                               out_specs=P("shard"), check_vma=False))
    z_sh = pt.unstack_dof(np.asarray(fn(r_st, tbs)))
    scale = np.max(np.abs(z_ref))
    assert np.max(np.abs(z_sh - z_ref)) < 1e-11 * scale


def test_sharded_record_matches_single_device():
    """Per-step trajectory records (error histories, envelopes) through the
    sharded runner must equal the single-device hook — the analogue of the
    reference gathering per-step outputs under MPI
    (Solvers/cylinder-diffraction.cpp:537-560)."""
    cfg = preset("pf_linear_periodic", nx=8, nz=2, order=3, nsteps=5,
                 cg_max_iter=600)
    prob = Problem(cfg)
    ns = prob.surf.n_dofs
    rec = lambda t, y, aux: (t, y[:ns])
    (t1, y1, _), (ts1, etas1) = prob.run(n_steps=5, record=rec)
    sprob = ShardedProblem(prob, mesh=make_device_mesh(4))
    (t2, y2, _), (ts2, etas2) = sprob.run(n_steps=5, record=rec)
    assert np.allclose(np.asarray(ts1), np.asarray(ts2))
    err = np.max(np.abs(np.asarray(etas1) - np.asarray(etas2)))
    assert err < 1e-10, err
    # chunked resume through the record path reuses the same executable
    (t3, y3, phi3), (ts3, etas3) = sprob.run(n_steps=5, record=rec)
    assert np.allclose(np.asarray(etas3), np.asarray(etas2))


def test_from_config_decentralized_setup():
    """ShardedProblem.from_config: setup computes on the host backend, every
    stacked table lands sharded (each device holds only its slice), lmax is
    estimated through the sharded operator, and the trajectory still matches
    the standard path to round-off."""
    from jax.sharding import NamedSharding

    cfg = preset("pf_linear_periodic", nx=8, ny=2, nz=2, order=3, nsteps=5,
                 cg_max_iter=600, precond="pmg")
    dm = make_device_mesh(4)
    sprob = ShardedProblem.from_config(cfg, device_mesh=dm)

    # every [ndev, ...] table must be sharded over the mesh, not replicated
    # or committed to one device
    def assert_sharded(x, name):
        assert isinstance(x.sharding, NamedSharding), name
        assert x.sharding.spec[0] == "shard", (name, x.sharding)
    for k, v in sprob.fine.tables.items():
        assert_sharded(v, f"fine.{k}")
    for li, t in enumerate(sprob.pmg.all_tables()["lv"]):
        for k, v in t.items():
            assert_sharded(v, f"pmg[{li}].{k}")
    assert_sharded(sprob.Jinv_z, "Jinv_z")

    t2, y2, _ = sprob.run(n_steps=5)

    prob = Problem(cfg)
    (t1, y1, _), _ = prob.run(n_steps=5)
    err = np.max(np.abs(np.asarray(y1) - np.asarray(y2)))
    scale = max(float(np.max(np.abs(np.asarray(y1)))), 1e-30)
    assert err < 1e-10 * scale, (err, scale)


def test_sharded_assembled_matches_single_device():
    """apply_mode="assembled" under shards — the reference's PF_linear_par
    configuration (full assembly + hypre ParCSR SpMV under MPI,
    Solvers/PF_linear_par.cpp:114-120): each shard assembles only its own
    elements in ELL form over the local [own|halo] layout and the CG rides
    gather_loc -> ELL row-sum -> assemble_own. The operator must equal the
    single-device AssembledLaplace exactly, and the trajectory must be
    shard-count invariant."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    cfg = preset("pf_linear_par", nx=12, order=3, apply_mode="assembled",
                 precond="jacobi")
    prob = Problem(cfg)
    assert prob.op_solve is not None

    # operator-level exactness (unconstrained apply)
    sp = prob.space
    ess = np.asarray(prob.surf.surf_to_vol)
    x = np.random.default_rng(0).standard_normal(sp.n_dofs)
    y_ref = np.asarray(prob.op_solve.apply(jnp.asarray(x)))
    dm = make_device_mesh(4)
    pt = Partition(sp, 4)
    from lpfem.shard import ShardedLevel
    lv = ShardedLevel(prob.op, pt, ess, ell=True, put=jnp.asarray)
    xs = jnp.asarray(pt.stack_dof(x, fill=0.0))

    def f(tb, xo):
        tb = jax.tree.map(lambda a: a[0], tb)
        return lv.apply_own(tb, xo[0])[None]

    tabs = dict(lv.tables)
    fm = shard_map(f, mesh=dm,
                   in_specs=(jax.tree.map(lambda _: P("shard"), tabs),
                             P("shard")),
                   out_specs=P("shard"))
    y_g = pt.unstack_dof(np.asarray(fm(tabs, xs))[:, : pt.N_max])
    assert np.max(np.abs(y_g - y_ref)) < 1e-12 * np.max(np.abs(y_ref))

    # trajectory shard-invariance (the mpirun-invariance analogue)
    (t1, y1, _), _ = prob.run(n_steps=3)
    sprob = ShardedProblem(prob, mesh=dm)
    assert sprob.fine._ell
    t2, y2, _ = sprob.run(n_steps=3)
    err = float(np.max(np.abs(np.asarray(y1) - np.asarray(y2))))
    scale = max(float(np.max(np.abs(np.asarray(y1)))), 1e-30)
    assert err < 1e-10 * scale, (err, scale)
