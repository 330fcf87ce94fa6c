"""Jitted Krylov solvers + preconditioners.

JAX replacement for MFEM's ``CGSolver``/``PCG`` and the
preconditioners the reference pairs with them: ``GSSmoother``+PCG (serial,
``Solvers/laplace_solver.cpp:112-113``), ``OperatorJacobiSmoother``+CG
(partial assembly, ``Solvers/PF_linear_par_partial.cpp:124,157-164``), and
``HypreBoomerAMG``+CG (full assembly, ``Solvers/laplace_solver_parallel.cpp:134-146``).

Tolerance semantics match MFEM: convergence is on the *preconditioned*
residual norm ``sqrt(r.z)``; the legacy ``PCG(..., RTOL, ATOL)`` helper
compares ``r.z`` (a squared quantity) against ``max(rz0*RTOL, ATOL)``, while
``CGSolver::SetRelTol(t)`` compares against ``rz0*t^2`` — both of which are
covered by the single ``rtol_sq`` argument here (pass ``1e-24`` to mirror the
reference's ``PCG(..., 1e-24, 0.0)`` calls, or ``rel_tol**2`` for
``SetRelTol``).

The entire CG loop is a ``lax.while_loop`` — one XLA computation per solve,
no host round-trips per iteration (the MPI version pays an Allreduce per dot
product; here the dots stay on the device, and in the sharded version they
are a ``psum`` across the device mesh inside the same program).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["CGResult", "pcg", "pcg_ir", "pcg_ir_ds", "pcg_refined",
           "jacobi_preconditioner"]


class CGResult(NamedTuple):
    x: jax.Array
    iters: jax.Array
    rz: jax.Array       # final preconditioned residual norm squared (r.z)
    rz0: jax.Array


def _default_dot(a, b):
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


def pcg(apply_fn: Callable, b: jax.Array, x0: jax.Array,
        precond_fn: Callable = lambda r: r,
        rtol_sq: float = 1e-24, atol_sq: float = 0.0,
        max_iter: int = 1000,
        dot_fn: Callable = _default_dot,
        grow_limit: float | None = 1e6) -> CGResult:
    """Preconditioned conjugate gradients (Hestenes-Stiefel, MFEM update order).

    ``dot_fn`` is a hook for distributed reductions: the sharded solver passes
    a local-dot + ``lax.psum`` composition so the same loop runs under
    ``shard_map`` unchanged.

    ``grow_limit`` is a finite-precision breakdown guard: when a tolerance
    sits at/below the achievable floor for the working precision (an f32
    solve asked for ~1e-10 on r.z, or MFEM's 1e-24 in f64), CG stalls at its
    floor and the stalled recurrence can break down — the iterate then grows
    without bound while staying finite (observed: f32 + Jacobi blowing a
    2e-3-scale solution up to 6e3 within a few hundred stalled iterations).
    The loop exits once r.z exceeds ``grow_limit`` times its running
    minimum — far beyond any transient CG non-monotonicity, so healthy
    solves are unaffected. ``None`` disables.
    """
    r = b - apply_fn(x0)
    z = precond_fn(r)
    d = z
    rz0 = dot_fn(r, z)
    threshold = jnp.maximum(rz0 * rtol_sq, atol_sq)

    def cond(state):
        x, r, d, rz, rz_min, it = state
        # NaN guard: a diverged/NaN preconditioner makes `rz > threshold`
        # False (NaN comparisons), which would silently look like instant
        # convergence; keep that exit behavior but the caller can detect it
        # via a non-finite CGResult.rz.
        go = jnp.logical_and(rz > threshold, it < max_iter)
        if grow_limit is not None:
            go = jnp.logical_and(go, rz < grow_limit * rz_min)
        return go

    def body(state):
        x, r, d, rz, rz_min, it = state
        Ad = apply_fn(d)
        dAd = dot_fn(d, Ad)
        # zero-denominator guards: if CG stagnates below the achievable
        # floor (e.g. rtol beyond f64 round-off, as the reference's 1e-24
        # squared tolerance sometimes is), hold the iterate instead of
        # producing NaNs; the iteration then idles until max_iter.
        alpha = jnp.where(dAd > 0, rz / jnp.where(dAd > 0, dAd, 1.0), 0.0)
        x = x + alpha * d
        r = r - alpha * Ad
        z = precond_fn(r)
        rz_new = dot_fn(r, z)
        beta = jnp.where(rz > 0, rz_new / jnp.where(rz > 0, rz, 1.0), 0.0)
        d = z + beta * d
        return (x, r, d, rz_new, jnp.minimum(rz_min, rz_new), it + 1)

    x, r, d, rz, rz_min, it = jax.lax.while_loop(
        cond, body, (x0, r, d, rz0, rz0, jnp.asarray(0, dtype=jnp.int32)))
    return CGResult(x=x, iters=it, rz=rz, rz0=rz0)


def jacobi_preconditioner(diag: jax.Array) -> Callable:
    """Diagonal (Jacobi) preconditioner — MFEM ``OperatorJacobiSmoother``
    over the assembled PA diagonal with essential dofs set to identity."""
    inv = 1.0 / diag
    return lambda r: r * inv


def pcg_ir(apply_hi: Callable, apply_lo: Callable, b: jax.Array,
           x0: jax.Array, precond_lo: Callable = lambda r: r,
           rtol_sq: float = 1e-24, atol_sq: float = 0.0,
           max_outer: int = 4, inner_rtol_sq: float = 1e-8,
           inner_max_iter: int = 1000,
           dot_fn: Callable = _default_dot) -> CGResult:
    """Fully-traced mixed-precision CG (iterative refinement) — the
    jit/scan-compatible twin of :func:`pcg_refined`, usable inside the fused
    RK4 time loop (``Problem`` with ``dtype="mixed"``).

    Outer ``lax.while_loop`` on the f64 true residual ``||b - A x||^2``
    around an inner f32 :func:`pcg` solve of the error equation. ``b``/``x0``
    set the high precision; the low side is float32.

    ``inner_rtol_sq`` must stay well ABOVE the f32 CG floor (~1e-10 on r.z
    with Jacobi): the outer passes supply the depth (one pass per
    ~sqrt(inner_rtol_sq) digits), and an inner tolerance at the floor is a
    knife-edge — a few-ulp perturbation decides between a 30-iteration exit
    and a stalled recurrence that breaks down (see ``pcg``'s grow_limit).
    """
    hi = b.dtype
    lo = jnp.float32
    x = x0.astype(hi)
    r = b - apply_hi(x)
    rr0 = dot_fn(r, r)
    threshold = jnp.maximum(rr0 * rtol_sq, atol_sq)

    def cond(st):
        x, r, rr, it, k = st
        return jnp.logical_and(rr > threshold, k < max_outer)

    def body(st):
        x, r, rr, it, k = st
        inner = pcg(apply_lo, r.astype(lo), jnp.zeros_like(r, dtype=lo),
                    precond_fn=precond_lo, rtol_sq=inner_rtol_sq,
                    max_iter=inner_max_iter, dot_fn=dot_fn)
        x = x + inner.x.astype(hi)
        r = b - apply_hi(x)
        return (x, r, dot_fn(r, r), it + inner.iters, k + 1)

    zero = jnp.asarray(0, dtype=jnp.int32)
    x, r, rr, it, k = jax.lax.while_loop(cond, body, (x, r, rr0, zero, zero))
    return CGResult(x=x, iters=it, rz=rr, rz0=rr0)


def pcg_ir_ds(apply_ds: Callable, apply_lo: Callable, b_ds, x0_ds,
              precond_lo: Callable = lambda r: r,
              rtol_sq: float = 1e-24, atol_sq: float = 0.0,
              max_outer: int = 4, inner_rtol_sq: float = 1e-8,
              inner_max_iter: int = 1000,
              dot_fn: Callable = _default_dot) -> CGResult:
    """Double-single (two-f32) twin of :func:`pcg_ir` — iterative refinement
    with the ENTIRE outer loop in DS arithmetic, no f64 anywhere.

    Why: where f64 is emulated, the f64 outer — residual applies and the
    vector work alike — costs far more than the f32 inner solve. Here
    ``b_ds``/``x0_ds`` are :class:`~lpfem.ds.DS` pairs, ``apply_ds`` maps
    DS -> DS with <= 1e-13 relative error vs the true f64 operator
    (``lpfem.ds.SeparableDS``), the residual/update algebra runs as error-free
    f32 transformations, and the inner CG consumes ``r.hi`` (the residual's
    leading f32 digits — all iterative refinement ever needs of it).

    Convergence is tested on ``||r.hi||^2`` against
    ``max(rr0 * rtol_sq, atol_sq)`` — same MFEM semantics as
    :func:`pcg_ir` (``Convergence_and_Scaling/ss.cpp:90-93``); the f32 dot
    is ample for a threshold spanning 16 orders of magnitude. Returns a
    CGResult whose ``x`` is the DS pair and whose ``rz``/``rz0`` are the
    outer ``||r||^2`` values (f32 scalars).
    """
    from .ds import ds_add_f32, ds_sub

    def rdot(r):
        return dot_fn(r.hi, r.hi)

    r = ds_sub(b_ds, apply_ds(x0_ds))
    rr0 = rdot(r)
    threshold = jnp.maximum(rr0 * jnp.float32(rtol_sq),
                            jnp.float32(atol_sq))

    def cond(st):
        x, r, rr, it, k = st
        return jnp.logical_and(rr > threshold, k < max_outer)

    def body(st):
        x, r, rr, it, k = st
        inner = pcg(apply_lo, r.hi, jnp.zeros_like(r.hi),
                    precond_fn=precond_lo, rtol_sq=inner_rtol_sq,
                    max_iter=inner_max_iter, dot_fn=dot_fn)
        x = ds_add_f32(x, inner.x)
        r = ds_sub(b_ds, apply_ds(x))
        return (x, r, rdot(r), it + inner.iters, k + 1)

    zero = jnp.asarray(0, dtype=jnp.int32)
    x, r, rr, it, k = jax.lax.while_loop(cond, body,
                                         (x0_ds, r, rr0, zero, zero))
    return CGResult(x=x, iters=it, rz=rr, rz0=rr0)


def pcg_refined(apply_hi: Callable, apply_lo: Callable, b: jax.Array,
                x0: jax.Array, precond_lo: Callable = lambda r: r,
                rtol_sq: float = 1e-24, atol_sq: float = 0.0,
                max_outer: int = 6, inner_rtol_sq: float = 1e-8,
                inner_max_iter: int = 1000,
                dot_fn: Callable = _default_dot) -> CGResult:
    """Mixed-precision CG via iterative refinement (defect correction).

    Reaches MFEM's double-precision CG tolerances
    (rel 1e-12 / 1e-24 on r.z, ``Solvers/PF_linear_par_partial.cpp:157-164``):
    single-precision CG stalls near sqrt(N)*eps_f32 ~ 1e-6 relative, while
    full f64 moves twice the bytes per apply. Here the hot work — the inner CG solve of the
    error equation ``A e = r`` — runs entirely in f32 (``apply_lo``,
    ``precond_lo``), and only the outer residual ``r = b - A x`` is computed
    in f64 (``apply_hi``, a handful of applies total). Each outer pass gains
    the f32 solve's ~5-6 digits, so 2-3 passes reach f64 floors.

    ``b``/``x0`` are f64; convergence is tested on ||r||^2 against
    ``max(rtol_sq * ||r0||^2, atol_sq)``. Returns a CGResult whose ``iters``
    counts TOTAL inner iterations and whose ``rz`` is the final outer
    ||r||^2.
    """
    hi = b.dtype
    lo = jnp.float32
    x = x0.astype(hi)
    r = b - apply_hi(x)
    rr0 = dot_fn(r, r)
    threshold = jnp.maximum(rr0 * rtol_sq, atol_sq)
    total_inner = 0
    rr = rr0
    for _ in range(max_outer):
        if float(rr) <= float(threshold):
            break
        inner = pcg(apply_lo, r.astype(lo), jnp.zeros_like(r, dtype=lo),
                    precond_fn=precond_lo, rtol_sq=inner_rtol_sq,
                    max_iter=inner_max_iter, dot_fn=dot_fn)
        total_inner += int(inner.iters)
        x = x + inner.x.astype(hi)
        r = b - apply_hi(x)
        rr = dot_fn(r, r)
    return CGResult(x=x, iters=jnp.asarray(total_inner, dtype=jnp.int32),
                    rz=rr, rz0=rr0)
