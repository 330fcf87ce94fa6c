"""Explicit time integration: classic RK4 over the free-surface state.

Replacement for MFEM's ``RK4Solver::Step`` (used everywhere,
e.g. ``Solvers/PF_linear_serial.cpp:339,491``): four RHS evaluations per
step with stage times (t, t+dt/2, t+dt/2, t+dt) and the standard
``y += dt/6 (k1 + 2 k2 + 2 k3 + k4)`` update.

The RHS signature is ``f(t, y, aux) -> (dy, aux)`` — ``aux`` (the volume
potential) threads through the stages sequentially, mirroring MFEM's mutable
``GridFunction &phi`` warm start. ``run`` wraps the step in ``lax.scan`` so
an entire time loop is a single compiled XLA program.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["rk4_step", "rk4_run"]


def rk4_step(f: Callable, t, dt, y, aux):
    """One classic RK4 step, rolled as a 4-iteration ``lax.scan``.

    Classic RK4's Butcher tableau is strictly subdiagonal, so each stage
    needs only the previous stage's k: ``y_i = y + dt*a_i*k_{i-1}``. Rolling
    the stages means the (potentially huge — CG + multigrid) RHS is traced
    and compiled ONCE per step instead of four times; for the V-cycle
    preconditioned solver this cuts XLA compile time ~4x with bit-identical
    results and evaluation order.
    """
    a = jnp.asarray([0.0, 0.5, 0.5, 1.0], dtype=y.dtype)
    c = jnp.asarray([0.0, 0.5, 0.5, 1.0], dtype=y.dtype)
    w = jnp.asarray([1.0, 2.0, 2.0, 1.0], dtype=y.dtype) / 6.0

    def stage(carry, coefs):
        k_prev, acc, aux = carry
        ai, ci, wi = coefs
        k, aux = f(t + ci * dt, y + (dt * ai) * k_prev, aux)
        return (k, acc + wi * k, aux), None

    k0 = jnp.zeros_like(y)
    (k, acc, aux), _ = jax.lax.scan(stage, (k0, k0, aux), (a, c, w))
    return y + dt * acc, aux


def rk4_run(f: Callable, y0, aux0, t0: float, dt: float, n_steps: int,
            record: Callable | None = None, guard: bool = True,
            guard_reduce: Callable | None = None):
    """Scan ``n_steps`` RK4 steps. If ``record(t, y, aux)`` is given its
    per-step outputs are stacked and returned as the second element.

    Returns ``((t, y, aux), outs, ok)``. With ``guard=True`` (default) each
    step's result is checked for finiteness inside the scan: once any step
    produces a non-finite state, the carry FREEZES at the last finite
    (t, y, aux) and ``ok`` comes back False — so a diverged CG stage cannot
    silently contaminate the rest of a fused multi-step program, and the
    last good state survives for checkpoint/diagnosis. The steady-state cost
    is one elementwise ``isfinite`` pass per step (negligible next to the
    four Laplace solves).

    ``guard_reduce`` makes the per-step flag globally consistent under SPMD
    (the sharded runner passes an all-reduce so one shard's NaN freezes every
    shard in the same step; divergent freezes would desynchronize the
    replicated surface state).
    """

    def body(carry, _):
        t, y, aux, ok = carry
        y_new, aux_new = rk4_step(f, t, dt, y, aux)
        if guard:
            fin = jnp.all(jnp.isfinite(y_new))
            for leaf in jax.tree_util.tree_leaves(aux_new):
                fin = jnp.logical_and(fin, jnp.all(jnp.isfinite(leaf)))
            if guard_reduce is not None:
                fin = guard_reduce(fin)
            ok = jnp.logical_and(ok, fin)
            y = jnp.where(ok, y_new, y)
            aux = jax.tree_util.tree_map(
                lambda a, b: jnp.where(ok, a, b), aux_new, aux)
            t = jnp.where(ok, t + dt, t)
        else:
            y, aux = y_new, aux_new
            t = t + dt
        out = record(t, y, aux) if record is not None else None
        return (t, y, aux, ok), out

    carry0 = (jnp.asarray(t0, dtype=y0.dtype), y0, aux0,
              jnp.asarray(True))
    (t, y, aux, ok), outs = jax.lax.scan(body, carry0, None, length=n_steps)
    return (t, y, aux), outs, ok
