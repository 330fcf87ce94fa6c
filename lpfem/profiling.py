"""Profiling & observability hooks.

The reference's only tracing is manual ``MPI_Barrier`` + ``MPI_Wtime``
around step loops with max-over-ranks reduction
(``Convergence_and_Scaling/ss.cpp:255-276``). Equivalents here:

- :class:`PhaseTimer` — wall-clock phases with ``block_until_ready``
  semantics (the barrier analogue) and a reference-style report.
- :func:`trace` — context manager around ``jax.profiler`` emitting an XLA
  trace viewable in TensorBoard/Perfetto (capability upgrade; the reference
  has no profiler integration, SURVEY.md §5).
- :func:`check_finite` — failure detection: validates solver state and
  raises with context (the reference has none; a diverged run just writes
  garbage, SURVEY.md §5 'Failure detection').
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax
import numpy as np

__all__ = ["PhaseTimer", "trace", "check_finite"]


class PhaseTimer:
    """Accumulating wall-clock phase timer.

    ``block=True`` waits for device work before reading the clock — the
    single-program analogue of the reference's ``MPI_Barrier``-bracketed
    ``MPI_Wtime`` (``ss.cpp:255-272``).
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def time(self, name: str, fn, *args, **kw):
        with self.phase(name):
            out = fn(*args, **kw)
            jax.block_until_ready(out)
        return out

    def report(self) -> str:
        lines = [f"{'phase':24s} {'calls':>6s} {'total[s]':>10s} {'mean[ms]':>10s}"]
        for k in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[k], self.counts[k]
            lines.append(f"{k:24s} {c:6d} {t:10.3f} {1e3 * t / max(c, 1):10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str = "/tmp/lpfem-trace"):
    """XLA profiler trace around a block (TensorBoard/Perfetto viewable)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def check_finite(name: str, *arrays) -> None:
    """Raise with context if any array contains non-finite values."""
    for i, a in enumerate(arrays):
        a = np.asarray(a)
        if not np.all(np.isfinite(a)):
            bad = int(np.sum(~np.isfinite(a)))
            raise FloatingPointError(
                f"{name}: array {i} has {bad}/{a.size} non-finite values "
                f"(max finite {np.nanmax(np.where(np.isfinite(a), a, np.nan))})")
