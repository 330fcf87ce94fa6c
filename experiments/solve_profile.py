"""Per-component timing of one RK4 stage: where does the solve wall go?

Times, each as a chained ``fori_loop`` program (median of repeats):
- constrained operator apply (the CG hot op)
- preconditioner V-cycle
- nodal z-derivative (the kinematic RHS)
- one full Laplace solve (warm start, protocol tolerance)
- one full RK4 step (4 solves + surface ODEs)

Usage: python -m experiments.solve_profile --refs 2
"""

from __future__ import annotations

import argparse
import statistics
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--refs", type=int, default=2)
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--precond", default="pmg")
    ap.add_argument("--cheb-degree", type=int, default=5)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--rtol-sq", type=float, default=1e-8,
                    help="CG tolerance (1e-16 = the faithful ss.cpp "
                         "protocol)")
    ap.add_argument("--hi-apply", default="auto", choices=["auto", "ds", "f64"],
                    help="outer arithmetic of dtype=mixed: native f64 "
                         "(auto/f64) or double-single (ds)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from lpfem.configs import preset
    from lpfem.params import jit_with_params
    from lpfem.problem import Problem

    cfg = preset("scaling_base", order=args.order, ref_levels=args.refs,
                 precond=args.precond, cheb_degree=args.cheb_degree,
                 dtype=args.dtype, cg_rtol_sq=args.rtol_sq, cg_max_iter=300,
                 hi_apply=args.hi_apply)
    prob = Problem(cfg)
    n = prob.space.n_dofs
    ns = prob.surf.n_dofs
    fso = prob.fso
    y0, phi0 = prob.initial_state()
    dev = jax.devices()[0]
    print(f"dofs={n} order={args.order} refs={args.refs} "
          f"precond={args.precond} hi_apply={args.hi_apply} "
          f"device={dev.platform}/{dev.device_kind} x{len(jax.devices())}")

    def timed(name, fn, *xs, iters=args.iters):
        f = jit_with_params(
            lambda x: jax.lax.fori_loop(0, iters, lambda i, v: fn(v), x),
            prob.params)
        jax.block_until_ready(f(*xs))
        walls = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(f(*xs))
            walls.append(time.perf_counter() - t0)
        ms = statistics.median(walls) / iters * 1e3
        print(f"{name:>24}: {ms:8.3f} ms")
        return ms

    x = jnp.asarray(phi0)
    ess = fso.ess
    timed("constrained apply", lambda v: prob.op.constrained_apply(v, ess),
          x.astype(prob.op.dtype))
    if fso.op_hi is not None:
        # mixed mode: the outer residual's f64 operator
        timed("f64 constrained apply",
              lambda v: fso.op_hi.constrained_apply(v, ess), x)
        timed("f64 axpy+dot", lambda v: v + jnp.vdot(v, v) * 1e-30 * v, x)
    if getattr(fso, "_ds_op", None) is not None:
        # double-single outer (hi_apply="ds"): time the DS residual apply
        # and the DS vector algebra it drives
        from lpfem.ds import DS, ds_add_f32, ds_sub
        x32 = x.astype(jnp.float32)

        def ds_apply(v):
            y = fso._ds_op.constrained_apply_top(v)
            return DS(y.hi, y.lo)
        timed("DS constrained apply", ds_apply,
              DS(x32, jnp.zeros_like(x32)))
        timed("DS sub+add+dot",
              lambda v: ds_add_f32(ds_sub(v, DS(v.hi * 0.5, v.lo * 0.5)),
                                   v.hi * jnp.vdot(v.hi, v.hi) * 1e-30),
              DS(x32, jnp.zeros_like(x32)))
    if args.precond == "pmg":
        timed("V-cycle", fso._precond, x.astype(prob.op.dtype))
    timed("z-derivative", lambda v: fso.zderiv(v), x)

    # full solve: fixed point of solve -> phi (keeps shapes, warm-started).
    # In the DS-outer mode the warm-start carry is a two-f32 pair (same
    # seeding as Problem.run).
    from lpfem.ds import ds_from_f64
    phi_seed = x
    phi0_seed = phi0
    if getattr(fso, "_ds_op", None) is not None:
        phi_seed = ds_from_f64(x.astype(jnp.float64))
        phi0_seed = ds_from_f64(jnp.asarray(phi0, jnp.float64))

    def solve1(phi):
        phi2, _ = fso.solve_laplace(y0[ns:], phi)
        return phi2
    timed("laplace solve (warm)", solve1, phi_seed,
          iters=max(4, args.iters // 4))

    def step1(carry):
        y, phi = carry
        from lpfem.timestep import rk4_step
        y2, phi2 = rk4_step(fso, 0.0, prob.dt, y, phi)
        return (y2, phi2)
    timed("full RK4 step", step1, (y0, phi0_seed),
          iters=max(2, args.iters // 8))


if __name__ == "__main__":
    main()
