"""Round-4 regression tests: advisor findings + bench robustness.

Covers the ADVICE.md round-3 items (isoparametric separable-lattice guard,
small-slab-first partition fallback, precision alias semantics, grid-line
validation, z-derivative HBM frugality).
"""

import numpy as np
import pytest

from lpfem.configs import preset
from lpfem.mesh import make_cartesian3d, set_curvature
from lpfem.operators import (LaplacePA, NodalZDerivative, SeparableLattice,
                             _matmul_precision)
from lpfem.problem import Problem
from lpfem.shard import Partition
from lpfem.space import H1Space

def test_make_cartesian3d_grid_validation():
    with pytest.raises(ValueError, match="strictly increasing"):
        make_cartesian3d(2, 1, 1, 1.0, 1.0, 1.0, xs=[0.0, 0.7, 0.5])
    with pytest.raises(ValueError, match="grid lines"):
        make_cartesian3d(2, 1, 1, 1.0, 1.0, 1.0, xs=[0.0, 1.0])
    # valid graded grid still builds
    m = make_cartesian3d(2, 1, 1, 1.0, 1.0, 1.0, xs=[0.0, 0.3, 1.0])
    assert m.elems.shape[0] == 2


def test_matmul_precision_float32_is_highest():
    import jax
    # JAX's own naming: 'float32' is an alias of Precision.HIGHEST; no name
    # also means exact f32 products (the GPU's default f32 matmul may be
    # TF32), and 'default' opts into the backend's choice
    assert _matmul_precision("float32") == jax.lax.Precision.HIGHEST
    assert _matmul_precision("highest") == jax.lax.Precision.HIGHEST
    assert _matmul_precision("high") == jax.lax.Precision.HIGH
    assert _matmul_precision(None) == jax.lax.Precision.HIGHEST
    assert _matmul_precision("default") == jax.lax.Precision.DEFAULT


def test_separable_refuses_isoparametric_geometry():
    """A geom_order>1 mesh whose CORNERS form an axis-aligned box lattice may
    still have a curved interior map; the Kronecker factorization must refuse
    it (it only inspects corners)."""
    import jax.numpy as jnp
    m = make_cartesian3d(4, 2, 2, 1.0, 0.5, 0.5)
    sp_flat = H1Space(m, 2)
    assert SeparableLattice.build(sp_flat, 3, jnp.float64) is not None
    set_curvature(m, 2)
    assert m.geom_order > 1 and m.geom_nodes is not None
    sp = H1Space(m, 2)
    assert SeparableLattice.build(sp, 3, jnp.float64) is None


def test_partition_small_slab_first_falls_back_to_compact():
    """A valid contiguous z-slab partition with small slabs FIRST does not
    qualify for the window layout (device 0 must carry the padded layer
    count) — it must fall back to the compact layout, not assert."""
    cfg = preset("scaling_base", nx=4, ny=2, nz=8, order=2)
    prob = Problem(cfg)
    st = prob.space.struct
    nex, ney, nez = st.elem_dims
    layer_dev = np.repeat([0, 1, 2, 3], [1, 2, 2, 3])     # small slab first
    part = np.repeat(layer_dev, ney * nex)
    pt = Partition(prob.space, 4, part=part)
    assert pt.win is None
    v = np.random.default_rng(0).standard_normal(prob.space.n_dofs)
    assert np.allclose(pt.unstack_dof(pt.stack_dof(v)), v)
    # largest-first still engages the window layout
    pt2 = Partition(prob.space, 4)
    assert pt2.win is not None


def test_zderivative_drops_full_jacobian_when_affine():
    """On affine meshes the compact [ne,3] metric suffices; the [ne,L,3]
    buffer must not be materialized (hundreds of MB at bench scale)."""
    import jax.numpy as jnp
    m = make_cartesian3d(3, 2, 2, 1.0, 0.5, 0.5)
    op = LaplacePA(H1Space(m, 3))
    zd = NodalZDerivative(op)
    assert zd.Jz3 is not None and zd.Jinv_z is None
    # and the derivative is still exact for a linear field
    sp = op.space
    phi = jnp.asarray(sp.project(lambda x, y, z: 2.5 * z))
    w = np.asarray(zd(phi))
    assert np.allclose(w, 2.5, atol=1e-12)
