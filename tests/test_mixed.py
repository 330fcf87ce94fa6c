"""Mixed-precision (f32 inner / f64 outer) solver path.

Model: MFEM runs everything in double with CG tolerances rel 1e-12 / 1e-24
on r.z (``Solvers/PF_linear_par_partial.cpp:157-164``). lpfem's answer
is iterative refinement (``lpfem.solvers.pcg_ir``): the hot CG runs in f32,
outer true residuals in f64 — reaching f64 floors at near-f32 speed. These
tests pin the accuracy contract on the CPU backend.
"""

import jax.numpy as jnp
import numpy as np

from lpfem.configs import preset
from lpfem.problem import Problem


def _laplace_system(order=4, nx=4, nz=2):
    from lpfem.analytic import AiryWave
    from lpfem.mesh import make_wave_tank
    from lpfem.operators import LaplacePA
    from lpfem.space import H1Space, SurfaceSpace

    mesh = make_wave_tank(nx, 1, nz)
    bbmin, bbmax = mesh.bounding_box()
    wave = AiryWave.from_modes(H=0.005, m=2.0, Lx=1.0,
                               h=bbmax[2] - bbmin[2], z_top=bbmax[2])
    sp = H1Space(mesh, order)
    surf = SurfaceSpace(sp, attr=2)
    ess = jnp.asarray(surf.surf_to_vol.astype(np.int32))
    phi_fs = jnp.asarray(surf.project(lambda x, y, z: wave.phi(x, y, z)),
                         dtype=jnp.float64)
    op32 = LaplacePA(sp, dtype=jnp.float32)
    op64 = LaplacePA(sp, dtype=jnp.float64)
    phi_ex = sp.project(lambda x, y, z: wave.phi(x, y, z))
    return op32, op64, ess, phi_fs, phi_ex


def test_pcg_ir_reaches_f64_floor():
    """f32-inner refinement must hit the same error floor as full-f64 CG
    (the f32-only solve stalls orders of magnitude above it)."""
    from lpfem.solvers import pcg, pcg_ir

    op32, op64, ess, phi_fs, phi_ex = _laplace_system()
    b64 = jnp.zeros(op64.n_dofs, dtype=jnp.float64)
    B64, x0 = op64.constrained_rhs(b64, ess, phi_fs)

    res_ir = pcg_ir(lambda v: op64.constrained_apply(v, ess),
                    lambda v: op32.constrained_apply(v, ess),
                    B64, x0, rtol_sq=1e-26, inner_rtol_sq=1e-10,
                    inner_max_iter=2000)
    res_64 = pcg(lambda v: op64.constrained_apply(v, ess), B64, x0,
                 rtol_sq=1e-26, max_iter=4000)

    err_ir = float(np.max(np.abs(np.asarray(res_ir.x) - phi_ex)))
    err_64 = float(np.max(np.abs(np.asarray(res_64.x) - phi_ex)))
    # both at the p=4 discretization floor; refinement within 2x of full f64
    assert err_ir < 2.0 * err_64 + 1e-15, (err_ir, err_64)
    # the outer residual really is at f64 depth, far below any f32 floor
    assert float(res_ir.rz) < 1e-20 * float(res_ir.rz0)


def test_pcg_ir_is_jittable():
    import jax
    from lpfem.solvers import pcg_ir

    op32, op64, ess, phi_fs, _ = _laplace_system(order=2)
    B64, x0 = op64.constrained_rhs(
        jnp.zeros(op64.n_dofs, dtype=jnp.float64), ess, phi_fs)

    @jax.jit
    def solve(B, x0):
        return pcg_ir(lambda v: op64.constrained_apply(v, ess),
                      lambda v: op32.constrained_apply(v, ess),
                      B, x0, rtol_sq=1e-24, inner_max_iter=1000)

    res = solve(B64, x0)
    assert float(res.rz) < 1e-20 * float(res.rz0)


def test_sharded_mixed_matches_single_device():
    """SPMD mixed precision: the sharded pcg_ir path (f64 outer level +
    f32 inner level) must reproduce the single-device mixed trajectory —
    the rank-invariance contract at MFEM-accuracy tolerances."""
    from lpfem.shard import ShardedProblem, make_device_mesh

    cfg = preset("pf_linear_periodic", nx=8, nz=2, order=3, nsteps=5,
                 cg_max_iter=600, dtype="mixed")
    prob = Problem(cfg)
    assert prob.op_hi is not None
    (t1, y1, phi1), _ = prob.run(n_steps=5)

    sprob = ShardedProblem(prob, mesh=make_device_mesh(4))
    assert sprob.fine_hi is not None
    t2, y2, phi2 = sprob.run(n_steps=5)

    assert y2.dtype == jnp.float64
    assert np.isclose(float(t1), float(t2))
    err = np.max(np.abs(np.asarray(y1) - np.asarray(y2)))
    scale = np.max(np.abs(np.asarray(y1)))
    assert err < 1e-10 * max(scale, 1.0), (err, scale)
    phi2g = sprob.phi_global(phi2)
    assert np.max(np.abs(np.asarray(phi1) - phi2g)) < 1e-10


def test_mixed_problem_matches_f64_trajectory():
    """dtype="mixed" must reproduce the full-f64 RK4 trajectory to
    near-round-off — the accuracy contract of the mixed configuration."""
    kw = dict(nsteps=60, cg_rtol_sq=1e-20, precond="pmg")
    pm = Problem(preset("pf_linear_periodic_par", dtype="mixed", **kw))
    p64 = Problem(preset("pf_linear_periodic_par", dtype="float64", **kw))
    assert pm.mixed and pm.op.dtype == jnp.float32 \
        and pm.op_hi.dtype == jnp.float64
    assert pm.dtype == jnp.float64

    (t, ym, phm), _ = pm.run(n_steps=10, state=pm.initial_state())
    (t2, y64, ph64), _ = p64.run(n_steps=10, state=p64.initial_state())
    pm.check_state(ym, phm)
    assert ym.dtype == jnp.float64
    # hi_apply="auto" keeps the native-f64 outer: the warm-start carry is
    # an f64 array, not a DS pair (lpfem.ds)
    from lpfem.ds import DS
    assert not isinstance(phm, DS) and phm.dtype == jnp.float64
    assert float(jnp.max(jnp.abs(ym - y64))) < 1e-12
    assert float(jnp.max(jnp.abs(phm - ph64))) < 1e-12


def test_mixed_setup_never_assembles_outer_diag():
    """Param registration must not force the f64 OUTER operator's lazy
    ``diag`` (a full E-vector diagonal assembly): it is never used in mixed
    mode — only the f32 inner operator preconditions — and at refs=4
    (137M dofs) that one setup program is what broke the remote compile."""
    prob = Problem(preset("pf_linear_periodic_par", dtype="mixed", nsteps=5))
    assert prob.op_hi is not None
    assert "diag" not in prob.op_hi.__dict__
    # the inner operator's diag IS materialized (Jacobi/pmg smoother)
    assert "diag" in prob.fso.op_solve.__dict__ \
        or prob.fso.op_solve.diag is not None
    # registered slots must not include (op_hi, "diag")
    assert (prob.op_hi, "diag") not in prob.params.slots
