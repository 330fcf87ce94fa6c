"""Headline benchmark: the reference's strong-scaling protocol on one GPU.

Protocol (``Convergence_and_Scaling/ss.cpp:90-93,254-286`` + ``ss.sh``):
10 RK4 steps = 40 Laplace solves on the periodic big wave tank, order 4,
partial assembly + CG with ``SetRelTol(1e-8)`` / maxit 300 — which in MFEM's
CGSolver semantics is convergence on ``r.z <= rz0 * 1e-16`` (the rel-tol is
squared; see ``lpfem/solvers.py``). Warm-up step excluded, wall time = max
over ranks (here: one fused XLA program, ``block_until_ready``).

An f32 solve cannot reach a 1e-16 relative floor, so the faithful run is
``dtype=mixed`` (f64 state + true residuals, exact-f32 inner operator) — the
default. The f32 @ rtol_sq 1e-8 configuration is reported as a clearly
labeled secondary metric in ``detail``.

Metric: DOF x Laplace-solves per second. The reference publishes no numbers
(BASELINE.md) and no earlier GPU record exists, so ``vs_baseline`` is 1.0.

The benchmark measures the accelerator: it refuses to run when JAX finds
only a CPU, and prints the device kind, the device count and the card's
name and power limit (``nvidia-smi``) beside every result.

Usage:
  python bench.py [--order 4] [--refs 2] [--dtype mixed] [--rtol-sq 1e-16]
  python bench.py --scales 1,2,3     # one JSON line per scale
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def card_info() -> str:
    """``name, power.limit`` of the first GPU as nvidia-smi reports them
    ("not available" where nvidia-smi is missing)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.strip().splitlines()[0] if out.strip() else "not available"


def require_accelerator() -> dict:
    """The device JAX runs on, as the benchmark reports it. Exits with an
    error when the first device is a CPU: a CPU time is not a device
    metric."""
    import jax
    d = jax.devices()[0]
    if d.platform == "cpu":
        sys.exit("bench.py measures the accelerator, and JAX found only a "
                 "CPU")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def bench_once(args, refs: int, dtype: str | None = None,
               rtol_sq: float | None = None) -> dict:
    """One protocol measurement at ``refs`` refinements. Returns wall, CG
    iteration count of the cold solve, the chained apply time, set-up and
    first-call times, and the problem with its final state."""
    import jax
    import jax.numpy as jnp
    from lpfem.configs import preset
    from lpfem.params import jit_with_params
    from lpfem.problem import Problem

    dtype = dtype or args.dtype
    rtol_sq = rtol_sq if rtol_sq is not None else args.rtol_sq
    cfg = preset("scaling_base", order=args.order, ref_levels=refs,
                 nx=args.nx, ny=args.ny, nz=args.nz, precond=args.precond,
                 cheb_degree=args.cheb_degree,
                 dtype=dtype, cg_rtol_sq=rtol_sq, cg_max_iter=300)
    t_setup = time.perf_counter()
    prob = Problem(cfg)
    n_dofs = prob.space.n_dofs
    ns = prob.surf.n_dofs
    y0, phi0 = prob.initial_state()
    setup_s = time.perf_counter() - t_setup

    def run_steps(n):
        (t, y, phi), _ = prob.run(n_steps=n, state=(y0, phi0))
        jax.block_until_ready(y)
        return t, y, phi

    # warm-up (excluded, like ss.cpp:254): the first call compiles, the
    # second runs the compiled program once
    t0 = time.perf_counter()
    run_steps(args.steps)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_steps(args.steps)
    warmup_s = time.perf_counter() - t0

    walls = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        t, y, phi = run_steps(args.steps)
        walls.append(time.perf_counter() - t0)
    dt_wall = statistics.median(walls)
    n_solves = 4 * args.steps

    # CG iterations of a cold solve (zero warm start) at the protocol
    # tolerance — the per-solve iteration count ss.cpp reports (for
    # dtype=mixed this is the TOTAL inner f32 iteration count of pcg_ir)
    solve = jit_with_params(
        lambda y_, p_: prob.fso.solve_laplace(y_[ns:], p_), prob.params)
    _, info = solve(y0, phi0)
    iters = int(info.iters)
    if not bool(info.converged):
        print(f"[bench] WARNING: cold solve unconverged at refs={refs} "
              f"(rz={float(info.rz):.3e} rz0={float(info.rz0):.3e})",
              file=sys.stderr)

    # chained constrained-apply time (the CG hot op)
    ess = prob.fso.ess
    n_ap = 30
    ap = jit_with_params(
        lambda x: jax.lax.fori_loop(
            0, n_ap, lambda i, v: prob.op.constrained_apply(v, ess), x),
        prob.params)
    x = jnp.asarray(phi0, dtype=prob.op.dtype)
    jax.block_until_ready(ap(x))
    ap_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(ap(x))
        ap_walls.append(time.perf_counter() - t0)
    apply_ms = statistics.median(ap_walls) / n_ap * 1e3

    return dict(refs=refs, n_dofs=int(n_dofs), wall_s=dt_wall,
                value=n_dofs * n_solves / dt_wall, n_solves=n_solves,
                cg_iters=iters, converged=bool(info.converged),
                apply_ms=apply_ms, dtype=dtype, rtol_sq=rtol_sq,
                setup_s=setup_s, compile_s=compile_s, warmup_s=warmup_s,
                walls=walls, prob=prob, state=(t, y, phi))


def _record(args, r: dict, sec: dict | None, device: dict) -> dict:
    return {
        "metric": "laplace_dof_throughput",
        "value": r["value"],
        "unit": "dof*solves/s",
        "vs_baseline": 1.0,
        "detail": {
            "vs_baseline_basis": "no comparable prior record",
            "protocol": "ss.cpp faithful: SetRelTol(1e-8) -> r.z<=rz0*1e-16"
                        if (args.rtol_sq == 1e-16 and args.dtype == "mixed")
                        else f"dtype={args.dtype} rtol_sq={args.rtol_sq}",
            "n_dofs": r["n_dofs"], "order": args.order, "refs": r["refs"],
            "steps": args.steps, "laplace_solves": r["n_solves"],
            "wall_s": r["wall_s"], "dtype": r["dtype"],
            "rtol_sq": r["rtol_sq"],
            "precond": args.precond,
            "cg_iters": r["cg_iters"], "converged": r["converged"],
            "apply_ms": r["apply_ms"],
            "walls": r["walls"],
            "setup_s": r["setup_s"], "compile_s": r["compile_s"],
            "warmup_s": r["warmup_s"],
            "secondary_f32": sec,
            "backend": device["platform"],
            "device_kind": device["kind"],
            "device_count": device["count"],
            "card": card_info(),
        },
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--refs", type=int, default=2,
                    help="2 = 2.18M dofs, the ss.cpp big-tank + 1 parallel "
                         "refinement protocol scale")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dtype", default="mixed",
                    help="mixed (faithful: f64 residuals + exact-f32 inner "
                         "operator, reaches the rz0*1e-16 floor) | float32 "
                         "| float64")
    ap.add_argument("--rtol-sq", type=float, default=1e-16,
                    help="CG convergence threshold on r.z relative to rz0 "
                         "(MFEM SetRelTol(t) == t^2 here; ss.cpp's "
                         "SetRelTol(1e-8) -> 1e-16)")
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--ny", type=int, default=2)
    ap.add_argument("--nz", type=int, default=8)
    ap.add_argument("--precond", default="pmg", choices=["jacobi", "chebyshev", "pmg"])
    ap.add_argument("--cheb-degree", type=int, default=4,
                    help="smoother degree for chebyshev/pmg")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timing repeats; median reported")
    ap.add_argument("--no-secondary", action="store_true",
                    help="skip the f32 @ rtol_sq=1e-8 secondary measurement")
    ap.add_argument("--scales", default=None,
                    help="comma list of refs (e.g. 1,2,3): run the protocol "
                         "at each scale, one JSON line each (the ss.cpp / "
                         "strongscaling.cpp problem sizes)")
    args = ap.parse_args()

    device = require_accelerator()
    print(f"[bench] {card_info()} | {device['kind']} x{device['count']}",
          file=sys.stderr)
    scales = ([int(s) for s in args.scales.split(",")] if args.scales
              else [args.refs])
    for refs in scales:
        r = bench_once(args, refs)
        sec = None
        if not args.no_secondary:
            s = bench_once(args, refs, dtype="float32", rtol_sq=1e-8)
            sec = {"value": s["value"], "wall_s": s["wall_s"],
                   "cg_iters": s["cg_iters"], "dtype": "float32",
                   "rtol_sq": 1e-8,
                   "note": "non-faithful softened protocol"}
        print(json.dumps(_record(args, r, sec, device)))


if __name__ == "__main__":
    main()
