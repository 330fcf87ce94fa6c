import jax.numpy as jnp
import numpy as np
import pytest

from lpfem.analytic import AiryWave
from lpfem.mesh import make_cartesian3d, make_wave_tank
from lpfem.operators import LaplacePA, NodalZDerivative
from lpfem.solvers import pcg, jacobi_preconditioner
from lpfem.space import H1Space, SurfaceSpace


@pytest.mark.parametrize("p,mode", [(1, "fused"), (2, "fused"), (3, "fused"),
                                    (2, "sumfact"), (4, "sumfact")])
def test_pa_apply_matches_assembled(p, mode):
    m = make_cartesian3d(2, 2, 2, 1.0, 0.7, 0.5)
    sp = H1Space(m, p)
    op = LaplacePA(sp, mode=mode)
    A = op.assemble_scipy()
    rng = np.random.default_rng(0)
    x = rng.standard_normal(sp.n_dofs)
    y_pa = np.asarray(op.apply(jnp.asarray(x)))
    y_sp = A @ x
    assert np.allclose(y_pa, y_sp, atol=1e-11)
    # diagonal matches
    assert np.allclose(np.asarray(op.diag), A.diagonal(), atol=1e-11)


@pytest.mark.parametrize("mode", ["fused", "sumfact"])
def test_pa_modes_agree(mode):
    m = make_wave_tank(4, 1, 2)
    sp = H1Space(m, 3)
    op1 = LaplacePA(sp, mode="fused")
    op2 = LaplacePA(sp, mode="sumfact")
    x = jnp.asarray(np.random.default_rng(1).standard_normal(sp.n_dofs))
    assert np.allclose(np.asarray(op1.apply(x)), np.asarray(op2.apply(x)), atol=1e-11)


def test_stiffness_nullspace_and_symmetry():
    m = make_cartesian3d(2, 1, 2, 1, 1, 1)
    sp = H1Space(m, 3)
    op = LaplacePA(sp)
    ones = jnp.ones(sp.n_dofs)
    assert np.allclose(np.asarray(op.apply(ones)), 0.0, atol=1e-11)
    # linear functions are in the kernel of the interior stiffness action
    # (A x)_i = int grad(x).grad(phi_i): for x = x-coordinate this equals the
    # boundary flux; just check symmetry via random vectors
    rng = np.random.default_rng(2)
    u = jnp.asarray(rng.standard_normal(sp.n_dofs))
    v = jnp.asarray(rng.standard_normal(sp.n_dofs))
    assert np.isclose(float(u @ op.apply(v)), float(v @ op.apply(u)), rtol=1e-12)


def _laplace_solve(sp, op, wave, surf_attr=2):
    """Reproduce Solvers/laplace_solver.cpp: project the analytic potential on
    the free surface, solve with zero-Neumann walls, compare in the volume."""
    surf = SurfaceSpace(sp, attr=surf_attr)
    phi_fs = surf.project(lambda x, y, z: wave.phi(x, y, z))
    ess = jnp.asarray(surf.surf_to_vol)
    b = jnp.zeros(sp.n_dofs)
    B, x0 = op.constrained_rhs(b, ess, jnp.asarray(phi_fs))
    diag_c = op.diag.at[ess].set(1.0)
    res = pcg(lambda v: op.constrained_apply(v, ess), B, x0,
              precond_fn=jacobi_preconditioner(diag_c),
              rtol_sq=1e-24, max_iter=2000)
    return res


def test_laplace_airy_validation_pconv():
    """p-convergence of the stationary Laplace solve against the Airy
    potential (laplace-parallel-pconv.cpp): error decays exponentially in p."""
    m = make_wave_tank(8, 1, 2)  # x-periodic tank, 4 elems/wavelength
    bbmin, bbmax = m.bounding_box()
    h = bbmax[2] - bbmin[2]
    wave = AiryWave.from_modes(H=0.005, m=2, Lx=1.0, h=h, z_top=bbmax[2])
    errs = []
    for p in [1, 2, 3, 4, 5]:
        sp = H1Space(m, p)
        op = LaplacePA(sp)
        res = _laplace_solve(sp, op, wave)
        err = float(op.l2_error(res.x, lambda x, y, z: wave.phi(x, y, z)))
        errs.append(err)
    errs = np.array(errs)
    # exponential decay overall (odd/even oscillation allowed at low res)
    assert errs[-1] < errs[0] * 1e-4, errs
    assert np.all(errs[2:] < errs[:-2]), errs
    assert errs[-1] < 1e-9, errs


def test_laplace_airy_hconv():
    """h-convergence at p=2: L2 error ~ h^(p+1) (laplace-parallel-hconv.cpp)."""
    errs = []
    p = 2
    for nx, nz in [(4, 2), (8, 4), (16, 8)]:
        m = make_wave_tank(nx, 1, nz)
        bbmin, bbmax = m.bounding_box()
        wave = AiryWave.from_modes(H=0.005, m=1, Lx=1.0, h=bbmax[2] - bbmin[2],
                                   z_top=bbmax[2])
        sp = H1Space(m, p)
        op = LaplacePA(sp)
        res = _laplace_solve(sp, op, wave)
        errs.append(float(op.l2_error(res.x, lambda x, y, z: wave.phi(x, y, z))))
    errs = np.array(errs)
    rates = np.log2(errs[:-1] / errs[1:])
    assert np.all(errs[1:] < errs[:-1]), errs
    # asymptotic rate ~ h^(p+1)
    assert rates[-1] > p + 0.5, (errs, rates)


def test_z_derivative_airy():
    """w = dphi/dz nodal projection vs the analytic vertical velocity
    (Solvers/laplace_solver.cpp:125-138)."""
    m = make_wave_tank(8, 1, 4)
    bbmin, bbmax = m.bounding_box()
    wave = AiryWave.from_modes(H=0.005, m=2, Lx=1.0, h=bbmax[2] - bbmin[2],
                               z_top=bbmax[2])
    rel = []
    for p in (2, 4):
        sp = H1Space(m, p)
        op = LaplacePA(sp)
        phi = jnp.asarray(sp.project(lambda x, y, z: wave.phi(x, y, z)))
        w = NodalZDerivative(op)(phi)
        w_ex = sp.project(lambda x, y, z: wave.w_vel(x, y, z))
        rel.append(np.max(np.abs(np.asarray(w) - w_ex)) / np.max(np.abs(w_ex)))
    # spectral convergence of the nodal derivative (measured: 1.7e-2 -> 3e-5)
    assert rel[1] < 1e-4, rel
    assert rel[1] < rel[0] / 100, rel


def test_polynomial_exactness_solve():
    """Dirichlet solve reproduces an exact harmonic polynomial to round-off."""
    m = make_cartesian3d(2, 2, 2, 1, 1, 1)
    sp = H1Space(m, 2)
    op = LaplacePA(sp)
    harm = lambda x, y, z: x * x - z * z + 2 * x * y   # harmonic, degree 2
    # Dirichlet on the whole boundary
    ess_np = np.unique(np.concatenate([sp.boundary_dofs(a) for a in range(1, 7)]))
    ess = jnp.asarray(ess_np)
    vals = jnp.asarray(sp.project(harm))[ess]
    B, x0 = op.constrained_rhs(jnp.zeros(sp.n_dofs), ess, vals)
    diag_c = op.diag.at[ess].set(1.0)
    res = pcg(lambda v: op.constrained_apply(v, ess), B, x0,
              precond_fn=jacobi_preconditioner(diag_c), rtol_sq=1e-28, max_iter=500)
    u_ex = sp.project(harm)
    assert np.allclose(np.asarray(res.x), u_ex, atol=1e-10)


def test_top_trace_fast_path():
    """NodalZDerivative.top_trace == full derivative restricted to the
    surface nodes (the RK4 RHS only needs the trace; on z-extruded geometry
    it reads just the top p+1 dof planes)."""
    from lpfem.space import SurfaceSpace

    m = make_wave_tank(6, 2, 3)
    for p in (2, 4):
        sp = H1Space(m, p)
        op = LaplacePA(sp)
        surf = SurfaceSpace(sp, attr=2)
        zd = NodalZDerivative(op)
        assert zd.enable_top_trace(surf.surf_to_vol)
        x = jnp.asarray(np.random.default_rng(3).standard_normal(sp.n_dofs))
        full = np.asarray(zd(x))[surf.surf_to_vol]
        fast = np.asarray(zd.top_trace(x))
        assert np.allclose(fast, full, atol=1e-12), np.max(np.abs(fast - full))

    # non-surface essential set must refuse the fast path
    zd2 = NodalZDerivative(LaplacePA(H1Space(m, 2)))
    assert not zd2.enable_top_trace(np.arange(4))


def test_top_trace_cylinder_mesh():
    """The polar cylinder tank (curved in-plane, straight z-extrusion) also
    qualifies: the inverse-Jacobian z-column is (0, 0, 2/hz) elementwise."""
    from lpfem.cylmesh import make_half_cylinder_tank
    from lpfem.space import SurfaceSpace

    m = make_half_cylinder_tank(Lx=4.0, Ly=2.0, cx=2.0, nz=2, n_theta=8,
                                n_r=4, a=0.5)
    sp = H1Space(m, 3)
    op = LaplacePA(sp)
    surf = SurfaceSpace(sp, attr=2)
    zd = NodalZDerivative(op)
    if not zd.enable_top_trace(surf.surf_to_vol):
        import pytest
        pytest.skip("cylinder tank did not take the lattice/extruded layout")
    x = jnp.asarray(np.random.default_rng(4).standard_normal(sp.n_dofs))
    full = np.asarray(zd(x))[surf.surf_to_vol]
    fast = np.asarray(zd.top_trace(x))
    assert np.allclose(fast, full, atol=1e-12), np.max(np.abs(fast - full))


def test_separable_kronecker_apply():
    """SeparableLattice (assembled tensor-product form) == element-local PA
    on axis-aligned tensor grids, incl. periodic x and graded spacing."""
    rng = np.random.default_rng(11)
    for m in (make_cartesian3d(3, 2, 2, 1.0, 0.7, 0.5),
              make_wave_tank(6, 2, 3)):
        for p in (1, 2, 4):
            sp = H1Space(m, p)
            op = LaplacePA(sp)                    # sep engages (mode=fused)
            assert op.sep is not None
            ref = LaplacePA(sp, mode="sumfact")   # element-local reference
            assert ref.sep is None
            x = jnp.asarray(rng.standard_normal(sp.n_dofs))
            ya, yb = np.asarray(op.apply(x)), np.asarray(ref.apply(x))
            scale = np.max(np.abs(yb))
            assert np.max(np.abs(ya - yb)) < 1e-11 * scale


def test_separable_constrained_and_fallback():
    from lpfem.cylmesh import make_half_cylinder_tank
    from lpfem.space import SurfaceSpace

    m = make_wave_tank(6, 2, 3)
    sp = H1Space(m, 3)
    op = LaplacePA(sp)
    surf = SurfaceSpace(sp, attr=2)
    assert op.enable_top_plane_ess(surf.surf_to_vol)
    ess = jnp.asarray(surf.surf_to_vol.astype(np.int32))
    x = jnp.asarray(np.random.default_rng(12).standard_normal(sp.n_dofs))
    ref = LaplacePA(sp, mode="sumfact")
    yref = ref.apply(x.at[ess].set(0.0))
    yref = np.asarray(yref.at[ess].set(x[ess]))
    ysep = np.asarray(op.constrained_apply(x, ess))
    assert np.allclose(ysep, yref, atol=1e-11 * np.max(np.abs(yref)))

    # curved lattice (polar block) must fall back to the element path
    mc = make_half_cylinder_tank(Lx=4.0, Ly=2.0, cx=2.0, nz=2, n_theta=8,
                                 n_r=4, a=0.5)
    assert LaplacePA(H1Space(mc, 2)).sep is None


def test_separable_graded_grid():
    """Graded (nonuniform per-axis) tensor grids stay separable: Kronecker
    apply (f64 and f32) and the top-plane trace all match the element-local
    reference."""
    from lpfem.space import SurfaceSpace

    zs = np.array([0.0, 0.35, 0.6, 0.8, 0.95, 1.0])   # packed to the top
    xs = np.array([0.0, 0.5, 0.8, 1.0])
    m = make_cartesian3d(3, 2, 5, 1.0, 0.7, 1.0, xs=xs, zs=zs)
    p = 3
    sp = H1Space(m, p)
    op = LaplacePA(sp)
    assert op.sep is not None
    ref = LaplacePA(sp, mode="sumfact")
    x = jnp.asarray(np.random.default_rng(21).standard_normal(sp.n_dofs))
    ya, yb = np.asarray(op.apply(x)), np.asarray(ref.apply(x))
    scale = np.max(np.abs(yb))
    assert np.max(np.abs(ya - yb)) < 1e-11 * scale

    surf = SurfaceSpace(sp, attr=6)     # MakeCartesian3D: attr 6 = z-top
    zd = NodalZDerivative(op)
    assert zd.enable_top_trace(surf.surf_to_vol)
    full = np.asarray(zd(x))[surf.surf_to_vol]
    assert np.allclose(np.asarray(zd.top_trace(x)), full, atol=1e-12)

    op32 = LaplacePA(sp, dtype=jnp.float32)
    assert op32.sep is not None
    yk = np.asarray(op32.apply(jnp.asarray(x, dtype=jnp.float32)))
    assert np.max(np.abs(yk - yb)) < 1e-5 * scale
