"""Preconditioner stack: Chebyshev, p-multigrid, assembled SpMV, GS parity."""

import jax.numpy as jnp
import numpy as np
import pytest

from lpfem.analytic import AiryWave
from lpfem.mesh import make_wave_tank
from lpfem.multigrid import ChebyshevSmoother, PMultigrid, estimate_lmax
from lpfem.operators import AssembledLaplace, LaplacePA
from lpfem.solvers import pcg
from lpfem.space import H1Space, SurfaceSpace


def _setup(p=4, nx=8, nz=4):
    m = make_wave_tank(nx, 1, nz)
    sp = H1Space(m, p)
    op = LaplacePA(sp)
    surf = SurfaceSpace(sp, attr=2)
    bbmin, bbmax = m.bounding_box()
    wave = AiryWave.from_modes(H=0.005, m=2, Lx=1.0, h=bbmax[2] - bbmin[2],
                               z_top=bbmax[2])
    ess = jnp.asarray(surf.surf_to_vol)
    phi_fs = jnp.asarray(surf.project(lambda x, y, z: wave.phi(x, y, z)))
    B, x0 = op.constrained_rhs(jnp.zeros(sp.n_dofs), ess, phi_fs)
    return sp, op, surf, wave, ess, B, x0


def test_pmg_cuts_iterations_at_same_accuracy():
    sp, op, surf, wave, ess, B, x0 = _setup()
    apply_c = lambda v: op.constrained_apply(v, ess)
    inv_diag = 1.0 / op.diag.at[ess].set(1.0)

    r_j = pcg(apply_c, B, x0, precond_fn=lambda r: r * inv_diag,
              rtol_sq=1e-24, max_iter=1000)
    pmg = PMultigrid(op, ess_dofs=np.asarray(surf.surf_to_vol))
    r_m = pcg(apply_c, B, x0, precond_fn=pmg, rtol_sq=1e-24, max_iter=1000)

    e_j = float(op.l2_error(r_j.x, lambda x, y, z: wave.phi(x, y, z)))
    e_m = float(op.l2_error(r_m.x, lambda x, y, z: wave.phi(x, y, z)))
    assert int(r_m.iters) < int(r_j.iters) / 3, (int(r_m.iters), int(r_j.iters))
    assert np.isclose(e_j, e_m, rtol=1e-3)


def test_pmg_iterations_h_independent():
    """The BoomerAMG-parity property: iteration counts stay ~flat under
    refinement (Jacobi-CG grows ~2x per refinement)."""
    iters = []
    for nx, nz in [(4, 2), (8, 4), (16, 8)]:
        sp, op, surf, wave, ess, B, x0 = _setup(p=2, nx=nx, nz=nz)
        pmg = PMultigrid(op, ess_dofs=np.asarray(surf.surf_to_vol))
        r = pcg(lambda v: op.constrained_apply(v, ess), B, x0,
                precond_fn=pmg, rtol_sq=1e-24, max_iter=1000)
        iters.append(int(r.iters))
    assert iters[-1] <= iters[0] + 6, iters


def test_chebyshev_beats_jacobi_iterations():
    sp, op, surf, wave, ess, B, x0 = _setup(p=3, nx=6, nz=3)
    apply_c = lambda v: op.constrained_apply(v, ess)
    inv_diag = 1.0 / op.diag.at[ess].set(1.0)
    lmax = estimate_lmax(apply_c, inv_diag, sp.n_dofs)
    cheb = ChebyshevSmoother(apply_c, inv_diag, lmax, degree=3)
    r_c = pcg(apply_c, B, x0, precond_fn=cheb, rtol_sq=1e-24, max_iter=1000)
    r_j = pcg(apply_c, B, x0, precond_fn=lambda r: r * inv_diag,
              rtol_sq=1e-24, max_iter=1000)
    assert int(r_c.iters) < int(r_j.iters) / 1.4, (int(r_c.iters), int(r_j.iters))


def test_assembled_spmv_matches_pa():
    sp, op, *_ = _setup(p=2, nx=4, nz=2)
    asm = AssembledLaplace(op)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(sp.n_dofs))
    assert np.allclose(np.asarray(asm.apply(x)), np.asarray(op.apply(x)),
                       atol=1e-11)


def test_gauss_seidel_host_smoothes():
    """Serial GSSmoother parity (Solvers/laplace_solver.cpp:112): SGS sweeps
    reduce the error of A x = b monotonically."""
    sp, op, surf, wave, ess, B, x0 = _setup(p=2, nx=4, nz=2)
    asm = AssembledLaplace(op)
    # constrained dense system
    import scipy.sparse as sp_
    A = asm._csr.tolil()
    e = np.asarray(ess)
    A[e, :] = 0.0
    A[:, e] = 0.0
    for i in e:
        A[i, i] = 1.0
    A = A.tocsr()
    asm2 = AssembledLaplace.__new__(AssembledLaplace)
    asm2._csr = A
    b = np.asarray(B)
    x = np.zeros_like(b)
    errs = []
    x_exact = sp_.linalg.spsolve(A.tocsc(), b)
    for _ in range(5):
        x = asm2.gauss_seidel_host(b, x, sweeps=1)
        errs.append(np.linalg.norm(x - x_exact))
    assert all(errs[i + 1] < errs[i] for i in range(4)), errs
    assert errs[-1] < errs[0] * 0.5


def test_pmg_h_coarsening_below_p1():
    """h-levels below p=1 via mesh halving (the lattice-identification trick:
    p=1 on the refined mesh == p=2 dof grid on the half mesh)."""
    from lpfem.mesh import make_wave_tank
    m = make_wave_tank(8, 2, 4)
    for _ in range(1):
        m = m.uniform_refine()
    sp = H1Space(m, 2)
    op = LaplacePA(sp)
    surf = SurfaceSpace(sp, attr=2)
    pmg = PMultigrid(op, ess_dofs=np.asarray(surf.surf_to_vol),
                     coarse_dense_limit=150, h_coarsen_min_dofs=300)
    assert len(pmg.levels) >= 3, [lv.op.n_dofs for lv in pmg.levels]
    # solve quality: same as before
    bbmin, bbmax = m.bounding_box()
    wave = AiryWave.from_modes(H=0.005, m=2, Lx=1.0, h=bbmax[2] - bbmin[2],
                               z_top=bbmax[2])
    ess = jnp.asarray(surf.surf_to_vol.astype(np.int32))
    pfs = jnp.asarray(surf.project(lambda x, y, z: wave.phi(x, y, z)))
    B, x0 = op.constrained_rhs(jnp.zeros(sp.n_dofs), ess, pfs)
    res = pcg(lambda v: op.constrained_apply(v, ess), B, x0, precond_fn=pmg,
              rtol_sq=1e-24, max_iter=500)
    assert int(res.iters) < 25, int(res.iters)


def test_lattice_transfer_fast_path_equivalence():
    """The dense per-axis grid transfers (lattice fast path) must compute the
    exact same operator as the element-path gather/interp/assemble, for
    p-transfers AND the h-transfer below p=1 (periodic x included)."""
    import jax.numpy as jnp
    from lpfem.mesh import make_wave_tank
    from lpfem.multigrid import PMultigrid
    from lpfem.operators import LaplacePA
    from lpfem.space import H1Space

    m = make_wave_tank(16, 4, 8)
    op = LaplacePA(H1Space(m, 4))
    mg = PMultigrid(op, h_coarsen_min_dofs=0, coarse_dense_limit=200)
    assert len(mg.transfers) >= 3          # p: 4->2->1, h: below p=1
    rng = np.random.default_rng(0)
    for li, tr in enumerate(mg.transfers):
        cl, fl = mg.levels[li + 1], mg.levels[li]
        assert tr.P1x is not None
        xc = jnp.asarray(rng.standard_normal(cl.op.n_dofs))
        rf = jnp.asarray(rng.standard_normal(fl.op.n_dofs))
        pf_new = tr.prolong(cl, fl, xc)
        rs_new = tr.restrict(cl, fl, rf)
        tr.P1x, keep = None, tr.P1x
        pf_old = tr.prolong(cl, fl, xc)
        rs_old = tr.restrict(cl, fl, rf)
        tr.P1x = keep
        assert float(jnp.max(jnp.abs(pf_new - pf_old))) < 1e-11
        assert float(jnp.max(jnp.abs(rs_new - rs_old))) < 1e-11
