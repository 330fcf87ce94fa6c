"""Device-facing entry points and precision: what the CPU suite can check of
the GPU path.

- ``chip_smoke.py`` and ``bench.py`` measure the accelerator: on the CPU
  they exit non-zero and print no result.
- the compile cache lands where ``JAX_COMPILATION_CACHE_DIR`` says, else at
  the fixed in-checkout ``.jax_cache/``.
- every f32 contraction on the solve path states ``Precision.HIGHEST``
  (a default f32 matmul may run in TF32 on the GPU).
- the sharded z-slab window layout runs the separable apply, never the
  gather fallback.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402

CPU_ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def _run(args, cwd=REPO, env=CPU_ENV, timeout=300):
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _json_lines(out: str):
    return [ln for ln in out.splitlines() if ln.startswith("{")]


def test_chip_smoke_refuses_cpu():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert not _json_lines(r.stdout)
    assert "needs a GPU" in r.stderr


def test_chip_smoke_needs_the_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert not _json_lines(r.stdout)


@pytest.mark.parametrize("platform,kind,count", [
    ("gpu", "NVIDIA H100 80GB HBM3", 1),
    ("gpu", "NVIDIA H100 80GB HBM3", 4),
])
def test_chip_smoke_result_line(platform, kind, count):
    line = chip_smoke.result_line(platform, kind, count)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}}
    assert line == ('{"ok": true, "device": {"platform": "%s", "kind": "%s", '
                    '"count": %d}}' % (platform, kind, count))


def test_bench_refuses_cpu():
    r = _run(["bench.py", "--refs", "0", "--order", "2", "--steps", "1",
              "--no-secondary"])
    assert r.returncode != 0
    assert not _json_lines(r.stdout)
    assert "only a CPU" in r.stderr


@pytest.mark.parametrize("case", ["missing", "silent"])
def test_card_info_without_nvidia_smi(case, monkeypatch, tmp_path):
    """No nvidia-smi on the PATH, or one that prints nothing."""
    if case == "silent":
        fake = tmp_path / "nvidia-smi"
        fake.write_text("#!/bin/sh\nexit 0\n")
        fake.chmod(0o755)
        monkeypatch.setenv("PATH", str(tmp_path))
    else:
        monkeypatch.setenv("PATH", "")
    assert bench.card_info() == "not available"


_CACHE_PROBE = ("import jax, lpfem; "
                "print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("case", ["env", "default", "off"])
def test_compile_cache_placement(case, tmp_path):
    env = dict(CPU_ENV)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.pop("LPFEM_NO_COMPILE_CACHE", None)
    if case == "env":
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
        want = str(tmp_path / "cc")
    elif case == "default":
        want = os.path.join(REPO, ".jax_cache")
    else:
        env["LPFEM_NO_COMPILE_CACHE"] = "1"
        want = "None"
    r = _run(["-c", _CACHE_PROBE], cwd=str(tmp_path), env=dict(
        env, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == want


def _dot_precisions(fn, *args):
    """Precision of every f32 dot_general in ``fn``'s jaxpr (sub-jaxprs
    included)."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                if any(v.aval.dtype == jnp.float32 for v in eqn.invars):
                    found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _pmg_problem():
    from lpfem.configs import preset
    from lpfem.problem import Problem
    return Problem(preset("scaling_base", nx=4, ny=2, nz=4, order=4,
                          dtype="float32", precond="pmg",
                          h_coarsen_min_dofs=0))


@pytest.mark.parametrize("part", ["prolong", "restrict", "coarse", "vcycle"])
def test_multigrid_f32_contractions_are_highest(part):
    prob = _pmg_problem()
    pmg = prob.fso._precond
    lv = pmg.levels
    if part == "prolong":
        fn, x = (lambda v: pmg.prolong(0, v)), jnp.ones(lv[1].op.n_dofs,
                                                         jnp.float32)
    elif part == "restrict":
        fn, x = (lambda v: pmg.restrict(0, v)), jnp.ones(lv[0].op.n_dofs,
                                                          jnp.float32)
    elif part == "coarse":
        fn, x = pmg.coarse_solve, jnp.ones(lv[-1].op.n_dofs, jnp.float32)
    else:
        fn, x = pmg, jnp.ones(lv[0].op.n_dofs, jnp.float32)
    precs = _dot_precisions(fn, x)
    assert precs, "no f32 contraction traced"
    hi = jax.lax.Precision.HIGHEST
    assert all(p is not None and all(q == hi for q in p) for p in precs), precs


@pytest.mark.parametrize("mode", ["fused", "sumfact"])
def test_element_apply_f32_contractions_are_highest(mode):
    from lpfem.cylmesh import make_half_cylinder_tank
    from lpfem.operators import LaplacePA, NodalZDerivative
    from lpfem.space import H1Space
    sp = H1Space(make_half_cylinder_tank(n_theta=8, n_r=4, nz=1), 2)
    op = LaplacePA(sp, dtype=jnp.float32, mode=mode)
    assert op.sep is None
    x = jnp.ones(sp.n_dofs, jnp.float32)
    zd = NodalZDerivative(op)
    for fn in (op.apply, zd):
        precs = _dot_precisions(fn, x)
        assert precs
        assert all(p == (jax.lax.Precision.HIGHEST,) * 2 for p in precs)


def test_removed_apply_mode_is_rejected():
    from lpfem.configs import Config
    from lpfem.mesh import make_wave_tank
    from lpfem.operators import LaplacePA
    from lpfem.space import H1Space
    assert Config().apply_mode == "fused"
    with pytest.raises(ValueError, match="apply mode"):
        LaplacePA(H1Space(make_wave_tank(4, 1, 2), 2), mode="pallas")


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_zslab_runs_separable_apply(ndev):
    """scaling_base mixed + pmg on the z-slab window layout: the fine f32
    and f64 levels and the p-levels apply the separable form per shard."""
    from lpfem.configs import preset
    from lpfem.problem import Problem
    from lpfem.shard import ShardedProblem, make_device_mesh
    cfg = preset("scaling_base", nx=4, ny=2, nz=8, order=4, dtype="mixed",
                 precond="pmg", nsteps=2)
    sprob = ShardedProblem(Problem(cfg, build_precond=False),
                           mesh=make_device_mesh(ndev))
    assert sprob.pt.win is not None
    assert sprob.fine._sep is not None and sprob.fine_hi._sep is not None
    p_levels = [lv for lv in sprob.pmg.levels if lv.op.space.p > 1]
    assert p_levels and all(lv._sep is not None for lv in p_levels)


@pytest.mark.gpu
def test_separable_apply_on_card(gpu_device):
    """chip_smoke's apply check at a small width, on the card."""
    res = chip_smoke.check_separable_apply(1, 4, n_time=5)
    assert res["plain_rel_err"] <= 1e-5
    assert res["constrained_rel_err"] <= 1e-5
