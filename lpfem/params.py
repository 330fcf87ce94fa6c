"""Big-array parameter threading for jit entry points.

Under jit, arrays captured by closure become jaxpr constants and get
embedded into the HLO module: at ~17M dofs the geometric factors alone are
~800MB, and every compile (and every compile-cache key) then carries them.

The fix is structural: large device buffers are *arguments*, not constants,
which keeps compiles small. :class:`BigParams` registers (object, attribute)
slots holding big arrays; ``jit_with_params`` wraps a function so the
registered arrays are collected into an explicit pytree argument and
temporarily bound onto their objects during tracing. Library code keeps
reading ``self.G`` etc. unchanged.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import jax
import numpy as np

__all__ = ["BigParams", "jit_with_params"]

_THRESHOLD_BYTES = 1 << 18   # register arrays above 256 KiB


class BigParams:
    def __init__(self):
        self.slots: list[tuple[object, str]] = []

    def register(self, obj, *attrs, force: bool = False) -> None:
        """Register attributes of ``obj`` holding large arrays."""
        for a in attrs:
            v = getattr(obj, a, None)
            if v is None:
                continue
            size = getattr(v, "nbytes", 0)
            if force or size >= _THRESHOLD_BYTES:
                if (obj, a) not in self.slots:
                    self.slots.append((obj, a))

    def collect(self) -> list:
        return [getattr(o, a) for o, a in self.slots]

    @contextlib.contextmanager
    def bound(self, vals):
        saved = [getattr(o, a) for o, a in self.slots]
        try:
            for (o, a), v in zip(self.slots, vals):
                setattr(o, a, v)
            yield
        finally:
            for (o, a), v in zip(self.slots, saved):
                setattr(o, a, v)


def jit_with_params(fn: Callable, params: BigParams, **jit_kw) -> Callable:
    """jit ``fn`` with the registered big arrays threaded as arguments."""

    def inner(args, kwargs, vals):
        with params.bound(vals):
            return fn(*args, **kwargs)

    jitted = jax.jit(inner, **jit_kw)

    def wrapped(*args, **kwargs):
        return jitted(args, kwargs, params.collect())

    wrapped._jitted = jitted
    return wrapped
