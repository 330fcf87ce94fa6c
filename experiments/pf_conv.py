"""Dynamic (time-dependent) potential-flow convergence studies.

Reproduces:
- p-convergence of the full RK4 solver over one period:
  ``||eta - eta_ex||_inf`` at t = T, p = 1..8, 150 steps
  (``Convergence_and_Scaling/convergence-parallel-partial.cpp:150-305``)
- h-convergence at fixed order measuring ``||w - w_ex||_inf``
  (``convergence-parallel-partial-hconv.cpp:142-351``)

Usage:
  python -m experiments.pf_conv --mode p --max-order 8
  python -m experiments.pf_conv --mode h --order 4 --refs 2
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["h", "p"], default="p")
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--refs", type=int, default=2)
    ap.add_argument("--max-order", type=int, default=8)
    ap.add_argument("--min-order", type=int, default=1,
                    help="first order of the p sweep (resume/extend an "
                         "existing append-only table)")
    ap.add_argument("--nx", type=int, default=8)
    ap.add_argument("--nz", type=int, default=2)
    ap.add_argument("--nsteps", type=int, default=150)
    ap.add_argument("--precond", default="pmg")
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32", "mixed"],
                    help="mixed reproduces the f64 convergence table with "
                         "an f32 inner CG + V-cycle and f64 outer residuals")
    ap.add_argument("--chunk", type=int, default=0,
                    help="max RK4 steps per dispatched program (0 = the "
                         "whole run; chunks reuse one cached executable)")
    ap.add_argument("--shard", type=int, default=0,
                    help="run each case through the n-device sharded runner "
                         "(the reference's mpirun form, convergence-"
                         "parallel.cpp:269-276); metrics must match the "
                         "single-device tables to round-off")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from lpfem.configs import preset
    from lpfem.problem import Problem
    from lpfem.io import DataFile
    from lpfem.operators import NodalZDerivative

    def run(order, mesh=None, nx=None, nz=None):
        cfg = preset("pf_linear_periodic", nx=nx or args.nx, nz=nz or args.nz,
                     order=order, nsteps=args.nsteps, cg_max_iter=2000,
                     dtype=args.dtype,
                     precond=args.precond if order > 1 else "jacobi")
        prob = Problem(cfg, mesh=mesh, build_precond=not args.shard)
        t0 = time.perf_counter()
        if args.shard:
            from lpfem.shard import ShardedProblem, make_device_mesh
            sprob = ShardedProblem(prob, mesh=make_device_mesh(args.shard))
            t, y, phi_st = sprob.run()
            phi = np.asarray(sprob.phi_global(phi_st))
        else:
            # optional host-side chunking (see --chunk)
            import jax
            t, y, phi, left = 0.0, *prob.initial_state(), cfg.nsteps
            while left > 0:
                n = min(args.chunk or cfg.nsteps, left)
                (t, y, phi), _ = prob.run(n_steps=n, t0=float(t),
                                          state=(y, phi))
                jax.block_until_ready(y)
                left -= n
        wall = time.perf_counter() - t0
        eta_err = prob.eta_error_inf(y, float(t))
        # w error at final time (the hconv driver's metric); mixed carries
        # the f64 state so the derivative runs through the f64 operator
        w = np.asarray(NodalZDerivative(prob.op_hi or prob.op)(np.asarray(phi)))
        w_ex = prob.space.project(
            lambda x, yy, z: prob.wave.w_vel(x, yy, z, float(t)))
        w_err = float(np.max(np.abs(w - w_ex)))
        return prob, dict(dofs=prob.surf.n_dofs, eta_err=eta_err,
                          w_err=w_err, wall=wall)

    if args.mode == "p":
        out = args.out or "data/pf-parallel-pconv-eta.txt"
        df = DataFile(out, "order surf_dofs eta_err_inf w_err_inf wall_s")
        for p in range(args.min_order, args.max_order + 1):
            _, r = run(p)
            df.append(p, r["dofs"], r["eta_err"], r["w_err"], r["wall"])
            print(f"p={p:2d} eta_err={r['eta_err']:.3e} w_err={r['w_err']:.3e} "
                  f"wall={r['wall']:.1f}s")
    else:
        out = args.out or f"data/pf-parallel-hconv-w{args.order}.txt"
        df = DataFile(out, "ref order surf_dofs eta_err_inf w_err_inf wall_s")
        from lpfem.mesh import make_wave_tank
        mesh = make_wave_tank(args.nx, 1, args.nz)
        for ref in range(args.refs + 1):
            _, r = run(args.order, mesh=mesh)
            df.append(ref, args.order, r["dofs"], r["eta_err"], r["w_err"],
                      r["wall"])
            print(f"ref={ref} eta_err={r['eta_err']:.3e} w_err={r['w_err']:.3e} "
                  f"wall={r['wall']:.1f}s")
            if ref < args.refs:
                mesh = mesh.uniform_refine()


if __name__ == "__main__":
    main()
