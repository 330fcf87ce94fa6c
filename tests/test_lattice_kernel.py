"""Separable-lattice apply in f32 (the inner operator of the mixed solve):
parity with the f64 element-local reference, and the element-path fallback
on curved lattices."""

import jax.numpy as jnp
import numpy as np
import pytest

from lpfem.mesh import make_wave_tank, make_wave_tank_finite
from lpfem.operators import LaplacePA
from lpfem.space import H1Space


@pytest.mark.parametrize("mk,args,p", [
    (make_wave_tank, (6, 2, 3), 4),          # periodic x
    (make_wave_tank_finite, (5, 2, 2), 3),   # non-periodic x
    (make_wave_tank, (4, 2, 2), 1),          # p=1 (the MG h-levels)
])
def test_sep_kernel_matches_reference(mk, args, p):
    """f32 banded Kronecker apply == f64 element-local reference,
    unconstrained and with the fused top-plane Dirichlet constraint."""
    mesh = mk(*args)
    sp = H1Space(mesh, p)
    op64 = LaplacePA(sp, dtype=jnp.float64, mode="sumfact")
    x = jnp.asarray(np.random.default_rng(2).standard_normal(sp.n_dofs))

    op32 = LaplacePA(sp, dtype=jnp.float32)
    assert op32.sep is not None, "separable form did not engage"
    x32 = jnp.asarray(x, dtype=jnp.float32)

    y_ref = op64.apply(x)
    scale = float(jnp.max(jnp.abs(y_ref)))
    dev = float(jnp.max(jnp.abs(op32.apply(x32).astype(jnp.float64)
                                - y_ref))) / scale
    assert dev < 1e-5, dev

    from lpfem.space import SurfaceSpace
    s2v = SurfaceSpace(sp, attr=2).surf_to_vol
    assert op32.enable_top_plane_ess(s2v)
    ess64 = jnp.asarray(s2v)
    yc_ref = op64.apply(x.at[ess64].set(0.0)).at[ess64].set(x[ess64])
    yc = op32.constrained_apply(x32, jnp.asarray(s2v.astype(np.int32)))
    devc = float(jnp.max(jnp.abs(yc.astype(jnp.float64) - yc_ref))) / scale
    assert devc < 1e-5, devc


def test_fused_lattice_falls_back_on_curved_mesh():
    """A curved (polar-block) lattice has neither the compact affine metric
    nor the separable form: the apply takes the fused element einsums on
    the structured lattice and still matches the sum-factorized path."""
    from lpfem.cylmesh import make_half_cylinder_tank
    cyl = make_half_cylinder_tank(n_theta=8, n_r=4, nz=1)
    sp = H1Space(cyl, 2)
    op = LaplacePA(sp, dtype=jnp.float32, mode="fused")
    assert op.C6 is None and op.sep is None   # curved: no affine compaction
    assert op.lattice is not None
    ref = LaplacePA(sp, dtype=jnp.float64, mode="sumfact")
    x = jnp.asarray(np.random.default_rng(4).standard_normal(sp.n_dofs))
    y_ref = np.asarray(ref.apply(x))
    y = np.asarray(op.apply(x.astype(jnp.float32)))
    assert np.max(np.abs(y - y_ref)) < 1e-5 * np.max(np.abs(y_ref))
