"""Smoke tests for the experiment CLIs (tiny problem sizes).

These exercise the end-to-end driver surface the way a user would —
the reference's 'standalone program' verification style (SURVEY.md §4) —
while staying small enough for CI.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

# the CLIs run in subprocesses on the CPU backend, like the rest of the suite
ENV = dict(os.environ, JAX_PLATFORMS="cpu", LPFEM_X64="1")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, timeout=900):
    r = subprocess.run([sys.executable, "-u", "-m"] + args, cwd=REPO, env=ENV,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r.stdout


def test_laplace_conv_cli(tmp_path):
    out = tmp_path / "lp.txt"
    run_cli(["experiments.laplace_conv", "--mode", "p", "--max-order", "2",
             "--nx", "4", "--precond", "jacobi", "--out", str(out)])
    d = np.loadtxt(out, ndmin=2)
    assert d.shape[0] == 2 and d[1, 3] < d[0, 3]  # l2 error drops with p


def test_pf_run_cli():
    out = run_cli(["experiments.pf_run", "--preset", "pf_linear_periodic",
                   "--order", "2", "--nsteps", "4"])
    assert "Wave parameters" in out and "done:" in out
    assert "dispersion check" in out


def test_pf_run_checkpoint_resume(tmp_path):
    ck = tmp_path / "c.npz"
    run_cli(["experiments.pf_run", "--preset", "pf_linear_periodic",
             "--order", "2", "--nsteps", "4", "--checkpoint", str(ck)])
    out = run_cli(["experiments.pf_run", "--preset", "pf_linear_periodic",
                   "--order", "2", "--nsteps", "4", "--resume", str(ck)])
    assert "resumed from" in out


def test_scaling_cli(tmp_path):
    out = tmp_path / "s.txt"
    run_cli(["experiments.scaling", "--mode", "strong", "--shards", "1", "2",
             "--orders", "2", "--steps", "2", "--repeats", "1",
             "--virtual-devices", "2", "--out", str(out)], timeout=500)
    lines = [l for l in open(out) if not l.startswith("#")]
    assert len(lines) == 2


def test_plots_cli(tmp_path):
    d = tmp_path / "conv.txt"
    d.write_text("# order dofs err\n1 10 1e-2\n2 40 1e-4\n3 90 1e-6\n")
    run_cli(["experiments.plots", "convergence", str(d)])
    assert os.path.exists(str(d).replace(".txt", ".png"))


def test_diffraction_cli(tmp_path):
    out = tmp_path / "rim.txt"
    out_e = tmp_path / "exact.txt"
    run_cli(["experiments.diffraction", "--quick", "--nsteps", "20",
             "--periods", "1.0", "--chunk", "10", "--out", str(out),
             "--out-exact", str(out_e)])
    rim = np.loadtxt(out, ndmin=2)
    ex = np.loadtxt(out_e, ndmin=2)
    assert rim.shape[0] > 5 and np.all(rim[:, 1] >= 0)
    assert 0 <= rim[:, 0].min() and rim[:, 0].max() <= np.pi + 1e-9
    # analytic companion spans [0, pi] with the up-wave run-up ~2
    assert abs(ex[-1, 0] - np.pi) < 1e-9 and 1.5 < ex[-1, 1] < 2.5
