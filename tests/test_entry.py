"""Driver entry points: single-chip jittable step + multi-chip dryrun.

The dryrun is the deliverable analogue of the reference's mpirun
rank-count-invariance runs (reference Convergence_and_Scaling/ss.sh:17-37):
it must pass when called bare by the driver, regardless of prior JAX state
in the calling process.
"""

import sys

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])

import jax
import jax.numpy as jnp
import numpy as np

import __graft_entry__ as g


def test_entry_jits():
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    for leaf in jax.tree_util.tree_leaves(out):
        assert np.all(np.isfinite(np.asarray(leaf)))


def test_dryrun_multichip_with_live_backend():
    # conftest already initialized an 8-device CPU backend in this process,
    # so this exercises the subprocess re-exec path — the exact situation
    # in which an early multi-device driver call failed.
    assert g._jax_backend_live()
    g.dryrun_multichip(4)
