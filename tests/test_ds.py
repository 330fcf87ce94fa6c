"""Double-single (two-f32) arithmetic and the DS separable apply: the
accuracy contract that lets `pcg_ir_ds` stand in for the f64 outer operator
of the mixed solve (``hi_apply="ds"``): the DS apply must match f64 to
<= 1e-13 relative."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lpfem.ds import (DS, SeparableDS, ds_add_f32, ds_dot_hi, ds_from_f64,
                      ds_sub, ds_to_f64, split, two_prod_presplit, two_sum)


def test_two_sum_exact():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal(1000), jnp.float32)
    b = jnp.asarray(rng.standard_normal(1000) * 1e-5, jnp.float32)
    s, e = two_sum(a, b)
    exact = a.astype(jnp.float64) + b.astype(jnp.float64)
    got = s.astype(jnp.float64) + e.astype(jnp.float64)
    assert np.array_equal(np.asarray(exact), np.asarray(got))


def test_two_prod_exact():
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.standard_normal(1000), jnp.float32)
    b = jnp.asarray(rng.standard_normal(1000), jnp.float32)
    ah, al = split(a)
    bh, bl = split(b)
    p, e = two_prod_presplit(a, b, ah, al, bh, bl)
    exact = a.astype(jnp.float64) * b.astype(jnp.float64)
    got = p.astype(jnp.float64) + e.astype(jnp.float64)
    assert np.array_equal(np.asarray(exact), np.asarray(got))


def test_ds_roundtrip_and_vector_ops():
    rng = np.random.default_rng(2)
    x64 = jnp.asarray(rng.standard_normal(4096), jnp.float64)
    y64 = jnp.asarray(rng.standard_normal(4096), jnp.float64)
    x = ds_from_f64(x64)
    # a DS pair carries ~49 mantissa bits, not 53: roundtrip to ~2^-49
    assert float(jnp.max(jnp.abs(ds_to_f64(x) - x64))) <= 2.0 ** -48
    d = ds_sub(x, ds_from_f64(y64))
    err = np.asarray(jnp.abs(ds_to_f64(d) - (x64 - y64)))
    assert err.max() < 1e-13
    e32 = jnp.asarray(rng.standard_normal(4096), jnp.float32)
    u = ds_add_f32(x, e32)
    want = x64 + e32.astype(jnp.float64)
    err = np.asarray(jnp.abs(ds_to_f64(u) - want))
    # exact up to the DS representation floor (~2^-48 of the result)
    assert err.max() <= 2.0 ** -47 * np.abs(np.asarray(want)).max()


def _sep_problem(nx=6, ny=3, nz=4, order=3, periodic=True):
    from lpfem.configs import preset
    from lpfem.problem import Problem
    name = "pf_linear_periodic" if periodic else "pf_linear_serial"
    cfg = preset(name, nx=nx, ny=ny, nz=nz, order=order, nsteps=2)
    return Problem(cfg)


@pytest.mark.parametrize("periodic", [True, False])
def test_ds_separable_apply_matches_f64(periodic):
    prob = _sep_problem(periodic=periodic)
    sep = prob.op.sep
    assert sep is not None
    # f64 separable operator (build from the f64 twin of the op)
    from lpfem.operators import SeparableLattice
    sep64 = SeparableLattice.build(prob.space, prob.op.q, jnp.float64)
    rng = np.random.default_rng(3)
    x64 = jnp.asarray(rng.standard_normal(prob.space.n_dofs), jnp.float64)
    y64 = sep64.apply(x64)

    ds_op = SeparableDS(sep64)
    yds = ds_to_f64(ds_op.apply(ds_from_f64(x64)))
    rel = float(jnp.linalg.norm(yds - y64) / jnp.linalg.norm(y64))
    assert rel < 1e-13, rel


def test_ds_constrained_apply_top_matches_f64():
    prob = _sep_problem(periodic=True)
    from lpfem.operators import SeparableLattice
    sep64 = SeparableLattice.build(prob.space, prob.op.q, jnp.float64)
    rng = np.random.default_rng(4)
    x64 = jnp.asarray(rng.standard_normal(prob.space.n_dofs), jnp.float64)
    y64 = sep64.constrained_apply_top(x64)
    ds_op = SeparableDS(sep64)
    yds = ds_to_f64(ds_op.constrained_apply_top(ds_from_f64(x64)))
    rel = float(jnp.linalg.norm(yds - y64) / jnp.linalg.norm(y64))
    assert rel < 1e-13, rel


def test_ds_dot_hi_reasonable():
    rng = np.random.default_rng(5)
    x64 = jnp.asarray(rng.standard_normal(10000), jnp.float64)
    d = ds_from_f64(x64)
    got = float(ds_dot_hi(d, d))
    want = float(jnp.dot(x64, x64))
    assert abs(got - want) / want < 1e-5


def test_mixed_ds_solve_matches_f64_outer():
    """End-to-end: the DS-outer mixed solve (pcg_ir_ds) must reproduce the
    emulated-f64-outer trajectory — same fixed point, same tolerance
    semantics (``Convergence_and_Scaling/ss.cpp:90-93``)."""
    from lpfem.configs import preset
    from lpfem.problem import Problem
    from lpfem.ds import DS, ds_to_f64

    kw = dict(nx=4, nz=2, order=3, nsteps=4, dtype="mixed")
    p64 = Problem(preset("pf_linear_periodic", hi_apply="f64", **kw))
    pds = Problem(preset("pf_linear_periodic", hi_apply="ds", **kw))
    assert pds.fso._ds_op is not None
    (t1, y1, phi1), _ = p64.run()
    (t2, y2, phi2), _ = pds.run()
    assert isinstance(phi2, DS)
    assert float(jnp.max(jnp.abs(y1 - y2))) < 1e-10
    assert float(jnp.max(jnp.abs(phi1 - ds_to_f64(phi2)))) < 1e-9
    assert not bool(pds.last_solver_stats.unconverged)

    # chunked resume threads the DS carry bit-identically
    (ta, ya, pa), _ = pds.run(n_steps=2)
    (tb, yb, pb), _ = pds.run(n_steps=2, t0=float(ta), state=(ya, pa))
    assert float(jnp.max(jnp.abs(yb - y2))) == 0.0


def test_hi_apply_auto_gates_on_tolerance_and_platform():
    """'auto' never picks the DS outer: every backend lpfem runs on
    computes f64 natively, so the mixed solve keeps the native-f64 outer at
    every tolerance. 'ds' still forces the DS path (how the DS tests and
    the DS-vs-f64 timing run)."""
    from lpfem.configs import preset
    from lpfem.problem import Problem

    kw = dict(nx=4, nz=2, order=2, nsteps=2, dtype="mixed")
    for rtol_sq in (1e-24, 1e-16, 1e-8):
        auto = Problem(preset("pf_linear_periodic", cg_rtol_sq=rtol_sq, **kw))
        assert auto.fso._ds_op is None
    forced = Problem(preset("pf_linear_periodic", cg_rtol_sq=1e-16,
                            hi_apply="ds", **kw))
    assert forced.fso._ds_op is not None
    forced_tight = Problem(preset("pf_linear_periodic", cg_rtol_sq=1e-24,
                                  hi_apply="ds", **kw))
    assert forced_tight.fso._ds_op is not None
