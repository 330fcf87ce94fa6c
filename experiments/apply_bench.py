"""Operator-apply microbenchmark: the CG hot op, per path.

Default mode, on the ``scaling_base`` tank at ``--refs`` (f32, the inner
operator of the mixed solve), times the constrained Laplace apply:

1. single-device (:class:`~lpfem.operators.SeparableLattice` under XLA)
2. sharded z-slab window layout through the full shard_map exchange, over
   every visible device
3. sharded compact layout (gather + element einsums), the fallback a
   lattice mesh must not land on

``--cylinder`` times the apply tiers an imported or curved mesh can take on
the half-cylinder tank: declared lattice (structured unfold/fold + fused
element einsums), recovered z-extrusion (``ColumnLattice``) and the raw
``x[elem_dofs]`` gather.

Timing: ``iters`` chained applies inside one jitted ``fori_loop`` program;
median of ``repeats`` program walls. Every line names the device.

Usage: python -m experiments.apply_bench --refs 1 [--iters 100]
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np


def _time_program(fn, *args, repeats=5):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def _device() -> str:
    import jax
    d = jax.devices()[0]
    return f"{d.platform}/{d.device_kind} x{len(jax.devices())}"


def cylinder_main(args):
    """Apply tiers of the half-cylinder tank (reference
    ``Solvers/cylinder-diffraction.cpp:225``), f32 and f64."""
    import jax
    import jax.numpy as jnp
    from lpfem.cylmesh import make_half_cylinder_tank
    from lpfem.mesh import Mesh
    from lpfem.operators import LaplacePA
    from lpfem.params import BigParams, jit_with_params
    from lpfem.space import H1Space

    m = make_half_cylinder_tank(n_theta=args.n_theta, n_r=args.n_r,
                                nz=args.cyl_nz, geom_order=args.order,
                                dr_max=0.25)
    m2 = Mesh(m.verts, m.elems, m.corner_coords, m.bdr_quads, m.bdr_attrs,
              m.periodic, m.geom_nodes, m.geom_order,
              periodic_axes=m.periodic_axes)          # lattice stripped
    rng = np.random.default_rng(0)
    for label, mesh, structured in (("lattice", m, True),
                                    ("column", m2, True),
                                    ("gather", m2, False)):
        sp = H1Space(mesh, args.order, structured=structured)
        for dtype in (jnp.float32, jnp.float64):
            op = LaplacePA(sp, dtype=dtype)
            assert op.sep is None, "curved tank must take the element path"
            bp = BigParams()
            op.register_params(bp)
            x = jnp.asarray(rng.standard_normal(sp.n_dofs), dtype=dtype)
            n_it = args.iters

            def run(x, op=op, n_it=n_it):
                return jax.lax.fori_loop(0, n_it, lambda i, v: op.apply(v),
                                         x)

            t = _time_program(jit_with_params(run, bp), x,
                              repeats=args.repeats) / n_it
            print(f"cylinder {label:>8} {jnp.dtype(dtype).name}: "
                  f"{t * 1e3:.4f} ms/apply ({t / sp.n_dofs * 1e9:.3f} "
                  f"ns/dof, dofs={sp.n_dofs}, p={args.order}) "
                  f"[{_device()}]", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--refs", type=int, default=1)
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--ny", type=int, default=2)
    ap.add_argument("--nz", type=int, default=8)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--skip-compact", action="store_true",
                    help="skip the slow gather+einsum contrast")
    ap.add_argument("--cylinder", action="store_true",
                    help="benchmark the apply tiers of the half-cylinder "
                         "tank instead")
    ap.add_argument("--n-theta", type=int, default=96)
    ap.add_argument("--n-r", type=int, default=16)
    ap.add_argument("--cyl-nz", type=int, default=1)
    args = ap.parse_args()

    if args.cylinder:
        cylinder_main(args)
        return

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from lpfem.configs import preset
    from lpfem.params import BigParams, jit_with_params
    from lpfem.problem import Problem
    from lpfem.shard import Partition, ShardedLevel, make_device_mesh

    cfg = preset("scaling_base", order=args.order, ref_levels=args.refs,
                 nx=args.nx, ny=args.ny, nz=args.nz, dtype="float32")
    prob = Problem(cfg, build_precond=False)
    sp = prob.space
    n = sp.n_dofs
    ess = np.asarray(prob.surf.surf_to_vol)
    essj = jnp.asarray(ess.astype(np.int32))
    op = prob.op
    print(f"dofs={n} order={args.order} refs={args.refs} [{_device()}]")

    x = jnp.asarray(np.random.default_rng(0).standard_normal(n),
                    dtype=jnp.float32)
    iters = args.iters
    bp = BigParams()
    op.register_params(bp)

    def single(x):
        return jax.lax.fori_loop(
            0, iters, lambda i, v: op.constrained_apply(v, essj), x)

    t1 = _time_program(jit_with_params(single, bp), x,
                       repeats=args.repeats) / iters
    kind = "separable" if op.sep is not None else "element"
    print(f"single apply [{kind}]: {t1 * 1e3:.4f} ms "
          f"({n * 4 * 2 / t1 / 1e9:.1f} GB/s for one read + one write)")

    ndev = len(jax.devices())
    results = {"single_ms": t1 * 1e3}
    for layout, label in (("auto", "window"),
                          *(() if args.skip_compact else
                            (("compact", "compact"),))):
        pt = Partition(sp, ndev, layout=layout)
        if layout == "auto" and pt.win is None:
            print("window layout unavailable; skipping")
            continue
        lv = ShardedLevel(op, pt, ess)
        mesh = make_device_mesh(ndev)
        x_st = jnp.asarray(pt.stack_dof(np.asarray(x)))

        def dev_fn(x_st, tb):
            tb = jax.tree.map(lambda a: a[0], tb)
            return jax.lax.fori_loop(
                0, iters, lambda i, v: lv.apply_c(tb, v), x_st[0])[None]

        fn = jax.jit(jax.shard_map(
            dev_fn, mesh=mesh, in_specs=(P("shard"), P("shard")),
            out_specs=P("shard"), check_vma=False))
        t = _time_program(fn, x_st, lv.tables, repeats=args.repeats) / iters
        path = "separable" if lv._sep is not None else "gather+einsum"
        print(f"sharded[{label}/{path}] x{ndev}: {t * 1e3:.4f} ms "
              f"({t / t1:.2f}x single)")
        results[f"sharded_{label}_ms"] = t * 1e3

    print(results)


if __name__ == "__main__":
    main()
