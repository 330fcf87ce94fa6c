"""Strong / weak scaling harness over the device-mesh shard axis.

Reproduces the reference's protocol (``Convergence_and_Scaling/ss.cpp``,
``ws.cpp``, ``strongscaling.cpp`` + ``ss.sh``/``ws.sh``): 10 RK4 steps
(= 40 Laplace solves), orders {3,4}, warm-up step excluded, wall time =
max over ranks. Here shard counts sweep a 1-axis ``jax.sharding.Mesh``
(virtual CPU devices via ``--xla_force_host_platform_device_count`` when
real cards are absent); "max over ranks" is inherent — one XLA program,
one wall clock.

Strong mode: fixed mesh (wave-tank-big + par refs), shards {1,2,4,8}.
Weak mode: mesh family big/big2/big4/big8 paired with shards {1,2,4,8}
(``ws.cpp:116-128`` WeakMeshForRanks).

Usage:
  python -m experiments.scaling --mode strong --shards 1 2 4 8 --orders 3 4
  python -m experiments.scaling --mode weak
"""

from __future__ import annotations

import argparse
import os
import time


WEAK_MESHES = {1: (32, 2, 8), 2: (64, 2, 8), 4: (64, 2, 16), 8: (128, 2, 16)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["strong", "weak"], default="strong")
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--orders", type=int, nargs="+", default=[3, 4])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--par-ref", type=int, default=0,
                    help="extra refinements (strong mode)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--rtol-sq", type=float, default=1e-16,
                    help="CG threshold on r.z relative to rz0. MFEM "
                         "SetRelTol(t) == t^2 here: ss.cpp/ws.cpp use "
                         "SetRelTol(1e-8) -> 1e-16 (the default); "
                         "strongscaling.cpp's 150-step long run uses "
                         "SetRelTol(1e-12) -> 1e-24 (pass --rtol-sq 1e-24 "
                         "--steps 150 --par-ref 2)")
    ap.add_argument("--max-iter", type=int, default=300,
                    help="CG maxit (ss.cpp 300; strongscaling.cpp 2000)")
    ap.add_argument("--dtype", default="mixed",
                    help="mixed reaches the 1e-16/1e-24 floors; float32 "
                         "cannot")
    ap.add_argument("--precond", default="jacobi",
                    choices=["jacobi", "chebyshev", "pmg"],
                    help="ss.cpp uses partial assembly + Jacobi; pmg keeps "
                         "protocol-size (>=2M dof) rows tractable on the "
                         "virtual-CPU mesh")
    ap.add_argument("--virtual-devices", type=int, default=0,
                    help="force N virtual CPU devices (0 = use real devices)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="max RK4 steps per dispatched program (0 = the "
                         "whole run in one program; executables are cached "
                         "so chunking re-dispatches one compiled program)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.virtual_devices:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_force_host_platform_device_count={args.virtual_devices}")
        os.environ["JAX_PLATFORMS"] = "cpu"

    import jax
    if args.virtual_devices:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from lpfem.configs import preset
    from lpfem.problem import Problem
    from lpfem.shard import ShardedProblem, make_device_mesh
    from lpfem.io import DataFile

    out = args.out or f"data/{args.mode}-scaling.txt"
    if args.virtual_devices:
        where = ("virtual-device runs share one host CPU: they validate the "
                 "SPMD protocol and shard-count-invariant physics, not "
                 "hardware speedup")
    else:
        d = jax.devices()[0]
        where = f"{d.platform}/{d.device_kind} x{len(jax.devices())}"
    df = DataFile(out, "mode order par_ref shards dofs dtype rtol_sq precond "
                       "median_wall_s exchange NS halo_B_per_apply "
                       "runs...  [" + where + "]")
    chunk = args.chunk or args.steps

    for order in args.orders:
        for ns in args.shards:
            if args.mode == "weak":
                nx, ny, nz = WEAK_MESHES[min(WEAK_MESHES, key=lambda k: abs(k - ns))]
                nx, ny, nz = WEAK_MESHES.get(ns, (nx, ny, nz))
                par_ref = 0
            else:
                nx, ny, nz = WEAK_MESHES[1]
                par_ref = args.par_ref
            cfg = preset("scaling_base", order=order, nx=nx, ny=ny, nz=nz,
                         ref_levels=par_ref, dtype=args.dtype,
                         precond=args.precond,
                         cg_rtol_sq=args.rtol_sq, cg_max_iter=args.max_iter)
            prob = Problem(cfg, build_precond=False)
            sprob = ShardedProblem(prob, mesh=make_device_mesh(ns))
            y0, phi0 = prob.initial_state()
            # warm-up (excluded, ss.cpp:254) — also compiles; block so the
            # first timed repeat doesn't absorb leftover device work
            jax.block_until_ready(sprob.run(n_steps=1, state=(y0, phi0)))

            def timed_run():
                # every chunk reuses the one cached executable; the wall
                # spans all dispatches like the reference's MPI_Wtime
                # bracket
                t0 = time.perf_counter()
                t, y, phi, left = 0.0, y0, phi0, args.steps
                while left > 0:
                    n = min(chunk, left)
                    t, y, phi = sprob.run(n_steps=n, t0=float(t),
                                          state=(y, phi))
                    jax.block_until_ready(y)
                    left -= n
                return time.perf_counter() - t0

            timed_run()   # warm the chunk-size executables (compile excluded)
            walls = [timed_run() for _ in range(args.repeats)]
            med = float(np.median(walls))

            # ---- communication accounting (per operator apply) ----
            # one gather + one assemble per apply; ppermute moves each
            # device's O(|S|/shards) boundary segment to its neighbour, psum
            # all-reduces the whole |S|+1 buffer; halo traffic moves in the
            # inner-operator dtype (f32 for mixed)
            itemsize = np.dtype("float32" if args.dtype == "mixed"
                                else args.dtype).itemsize
            NS = sprob.pt.NS
            ex = sprob.fine.exchange
            if ex == "ppermute":
                seg = max(getattr(sprob.fine, "Wf", 0),
                          getattr(sprob.fine, "Ww", 0))
                halo_bytes = 2 * seg * itemsize
            else:
                halo_bytes = 2 * (NS + 1) * itemsize
            df.append(args.mode, order, par_ref, ns, prob.space.n_dofs,
                      args.dtype, args.rtol_sq, args.precond, med,
                      ex, NS, halo_bytes, *[round(w, 4) for w in walls])
            print(f"{args.mode} order={order} shards={ns} dofs={prob.space.n_dofs} "
                  f"median={med:.3f}s exchange={ex} NS={NS} "
                  f"halo_B/apply={halo_bytes}")


if __name__ == "__main__":
    main()
