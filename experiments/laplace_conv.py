"""Stationary Laplace convergence studies.

Reproduces:
- h-convergence: order 4, refinements 0..N, ``||phi - phi_ex||_inf`` + L2 vs
  DOFs (``Convergence_and_Scaling/laplace-parallel-hconv.cpp:28-228``)
- p-convergence: p = 1..10 on a fixed mesh
  (``Convergence_and_Scaling/laplace-parallel-pconv.cpp:21-219``)

Problem: project the analytic Airy potential on the free surface (attr 2),
solve the zero-Neumann Laplace problem, compare to the exact volume
potential (``Solvers/laplace_solver.cpp`` validation).

Usage:
  python -m experiments.laplace_conv --mode p --orders 1..10
  python -m experiments.laplace_conv --mode h --order 4 --refs 4
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def run_case(mesh, order, wave, rtol_sq, max_iter, precond="pmg",
             dtype="float64", max_outer=8, inner_precision="highest"):
    """One stationary solve. ``dtype``:
    - float64: everything double (the MFEM configuration)
    - float32: everything single
    - mixed:   f32 operator + preconditioner, f64 outer residuals
               (iterative refinement; hits f64 floors at near-f32 speed —
               the 'matching MFEM accuracy on chip' configuration)
    """
    import jax
    import jax.numpy as jnp
    from lpfem.space import H1Space, SurfaceSpace
    from lpfem.operators import LaplacePA
    from lpfem.solvers import pcg, pcg_refined

    sp = H1Space(mesh, order)
    jt = jnp.float32 if dtype == "float32" else jnp.float64
    # mixed: exact-f32 products in the inner operator's element paths — a
    # default-precision f32 matmul may run in TF32 on the GPU, which caps
    # the attainable inner correction
    op = LaplacePA(sp, dtype=jt if dtype != "mixed" else jnp.float32,
                   precision=inner_precision if dtype == "mixed" else None)
    surf = SurfaceSpace(sp, attr=2)
    ess = jnp.asarray(surf.surf_to_vol.astype(np.int32))
    phi_fs = jnp.asarray(surf.project(lambda x, y, z: wave.phi(x, y, z)),
                         dtype=jt)

    if precond == "pmg" and order > 1:
        from lpfem.multigrid import PMultigrid
        pre = PMultigrid(op, ess_dofs=np.asarray(surf.surf_to_vol))
    else:
        inv_diag = 1.0 / op.diag.at[ess].set(1.0)
        pre = lambda r: r * inv_diag

    if dtype == "mixed":
        op64 = LaplacePA(sp, dtype=jnp.float64, mode="fused")
        B, x0 = op64.constrained_rhs(jnp.zeros(sp.n_dofs, dtype=jnp.float64),
                                     ess, phi_fs)
        apply_hi = jax.jit(lambda v: op64.constrained_apply(v, ess))
        apply_lo = jax.jit(lambda v: op.constrained_apply(v, ess))
        t0 = time.perf_counter()
        res = pcg_refined(apply_hi, apply_lo, B, x0, precond_lo=pre,
                          rtol_sq=rtol_sq, inner_max_iter=max_iter,
                          max_outer=max_outer)
        jax.block_until_ready(res.x)
        wall = time.perf_counter() - t0
    else:
        B, x0 = op.constrained_rhs(jnp.zeros(sp.n_dofs, dtype=jt), ess, phi_fs)
        t0 = time.perf_counter()
        res = pcg(lambda v: op.constrained_apply(v, ess), B, x0,
                  precond_fn=pre, rtol_sq=rtol_sq, max_iter=max_iter)
        jax.block_until_ready(res.x)
        wall = time.perf_counter() - t0

    phi_ex = sp.project(lambda x, y, z: wave.phi(x, y, z))
    err_inf = float(np.max(np.abs(np.asarray(res.x) - phi_ex)))
    l2op = op if dtype != "mixed" else op64
    err_l2 = float(l2op.l2_error(res.x.astype(l2op.dtype),
                                 lambda x, y, z: wave.phi(x, y, z)))
    return dict(dofs=sp.n_dofs, iters=int(res.iters), err_inf=err_inf,
                err_l2=err_l2, wall=wall)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["h", "p"], default="p")
    ap.add_argument("--order", type=int, default=4, help="order for h-mode")
    ap.add_argument("--refs", type=int, default=3, help="max refinements (h-mode)")
    ap.add_argument("--max-order", type=int, default=10, help="p-mode sweep top")
    ap.add_argument("--nx", type=int, default=8)
    ap.add_argument("--nz", type=int, default=2)
    ap.add_argument("--modes", type=float, default=2.0)
    ap.add_argument("--rtol-sq", type=float, default=1e-24)
    ap.add_argument("--max-iter", type=int, default=2000)
    ap.add_argument("--precond", default="pmg")
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32", "mixed"])
    ap.add_argument("--max-outer", type=int, default=8,
                    help="mixed: refinement passes (each gains the inner "
                         "solve's digits; high p needs more)")
    ap.add_argument("--inner-precision", default="highest",
                    choices=["default", "high", "highest"],
                    help="mixed: matmul precision of the f32 inner "
                         "operator (default = TF32 on the GPU)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from lpfem.analytic import AiryWave
    from lpfem.mesh import make_wave_tank
    from lpfem.io import DataFile

    base = make_wave_tank(args.nx, 1, args.nz)
    bbmin, bbmax = base.bounding_box()
    wave = AiryWave.from_modes(H=0.005, m=args.modes, Lx=1.0,
                               h=bbmax[2] - bbmin[2], z_top=bbmax[2])

    if args.mode == "p":
        out = args.out or "data/laplace-pconv-phi.txt"
        df = DataFile(out, "order dofs err_inf err_l2 iters wall_s")
        for p in range(1, args.max_order + 1):
            r = run_case(base, p, wave, args.rtol_sq, args.max_iter,
                         args.precond, dtype=args.dtype,
                         max_outer=args.max_outer,
                         inner_precision=args.inner_precision)
            df.append(p, r["dofs"], r["err_inf"], r["err_l2"], r["iters"], r["wall"])
            print(f"p={p:2d} dofs={r['dofs']:8d} err_inf={r['err_inf']:.3e} "
                  f"err_l2={r['err_l2']:.3e} iters={r['iters']} wall={r['wall']:.2f}s")
    else:
        out = args.out or "data/laplace-hconv-phi.txt"
        df = DataFile(out, "ref order dofs err_inf err_l2 iters wall_s")
        mesh = base
        for ref in range(args.refs + 1):
            r = run_case(mesh, args.order, wave, args.rtol_sq, args.max_iter,
                         args.precond, dtype=args.dtype,
                         max_outer=args.max_outer,
                         inner_precision=args.inner_precision)
            df.append(ref, args.order, r["dofs"], r["err_inf"], r["err_l2"],
                      r["iters"], r["wall"])
            print(f"ref={ref} dofs={r['dofs']:8d} err_inf={r['err_inf']:.3e} "
                  f"err_l2={r['err_l2']:.3e} iters={r['iters']} wall={r['wall']:.2f}s")
            if ref < args.refs:
                mesh = mesh.uniform_refine()


if __name__ == "__main__":
    main()
