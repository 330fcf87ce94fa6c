"""Double-single (two-float32) arithmetic: f64-class accuracy at f32 speed.

Why this exists: on hardware where f64 is emulated, the outer loop of the
mixed-precision faithful-tolerance solve (``solvers.pcg_ir``) — f64 vector
ops and residual applies — costs far more than the f32 inner solve. The
GPU computes f64 natively, so ``hi_apply="auto"`` never picks this path;
it stays reachable through ``hi_apply="ds"`` for comparison (PERF.md has
its time against the native-f64 outer).

The scheme keeps the high-precision state as an explicit pair of f32
arrays ``(hi, lo)`` with ``value = hi + lo`` and ``|lo| <= ulp(hi)/2``
(~2^-48 relative, ~14.4 decimal digits), and runs error-free
transformations in f32:

- ``two_sum``      Knuth's branch-free exact add (6 flops)
- ``split``        Veltkamp 12-bit split (f32: factor 2^12 + 1)
- ``two_prod_presplit``  Dekker product with pre-split operands (no FMA —
  XLA gives no single-rounding fma primitive, and relying on fusion to
  produce one is not portable)

The residual arithmetic of iterative refinement needs exactly three vector
operations in DS (everything else stays plain f32): ``r = b - A x``,
``x += e`` and a norm — see :func:`ds_sub`, :func:`ds_add_f32`,
:func:`ds_dot_hi`. The banded Kronecker DS apply lives in
:class:`SeparableDS`.

Accuracy contract (tested in ``tests/test_ds.py``): the DS separable apply
matches the f64 assembled operator to <= 1e-13 relative — the bound the
mixed solve needs — so ``pcg_ir_ds`` converges to the same fixed
point as the emulated-f64 outer it replaces
(``Convergence_and_Scaling/ss.cpp:90-93`` tolerance semantics at f64
fidelity).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "DS", "ds_from_f64", "ds_to_f64", "two_sum", "fast_two_sum", "split",
    "two_prod_presplit", "ds_add_f32", "ds_sub", "ds_neg", "ds_dot_hi",
    "ds_where", "SeparableDS",
]

_SPLIT = np.float32(4097.0)          # 2^12 + 1 (Veltkamp, f32)


class DS(NamedTuple):
    """A double-single value/array: ``value = hi + lo`` (both float32)."""
    hi: jax.Array
    lo: jax.Array


def ds_from_f64(x: jax.Array) -> DS:
    """Exact split of an f64 array into a DS pair (hi = round(x), lo = the
    f32-representable remainder; |x - hi - lo| <= 2^-49 ulp-level)."""
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
    return DS(hi, lo)


def ds_from_f32(x: jax.Array) -> DS:
    return DS(x, jnp.zeros_like(x))


def ds_to_f64(d: DS) -> jax.Array:
    return d.hi.astype(jnp.float64) + d.lo.astype(jnp.float64)


def _opaque(a, b):
    """Hide a value pair from XLA's HLO rewriter (CSE / reassociation).

    CAVEAT: on XLA:CPU under jit this is NOT sufficient — the fusion pass
    duplicates cheap multiplies into every consumer fusion straight
    through the barrier, and LLVM contracts the fused mul+add into an
    fma, demoting a jitted DS stream to plain-f32 accuracy. Eager CPU
    execution (how the accuracy tests run) is exact. XLA:GPU's LLVM
    backend may contract the same way; PERF.md records whether the
    ``hi_apply="ds"`` solve still converges on the card."""
    return jax.lax.optimization_barrier((a, b))


def two_sum(a, b):
    """Knuth exact addition: a + b = s + e with s = fl(a+b). 6 flops,
    branch-free (no magnitude precondition)."""
    a, b = _opaque(a, b)
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Dekker exact addition, REQUIRES |a| >= |b| (or a == 0). 3 flops."""
    a, b = _opaque(a, b)
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Veltkamp split: a = h + l with h, l having <= 12 significant bits,
    so products h*h', h*l', l*l' of split values are exact in f32."""
    c, a = _opaque(_SPLIT * a, a)
    h = c - (c - a)
    return h, a - h


def two_prod_presplit(a, b, ah, al, bh, bl):
    """Dekker product: a * b = p + e exactly, with (ah, al) = split(a),
    (bh, bl) = split(b) supplied by the caller (hoisted out of loops)."""
    p = a * b
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def ds_norm(hi, lo) -> DS:
    """Renormalize a (hi, lo) pair so |lo| <= ulp(hi)/2."""
    return DS(*fast_two_sum(hi, lo))


def ds_add_f32(x: DS, e) -> DS:
    """x + e with e a plain f32 array (the IR update ``x += correction``)."""
    s, err = two_sum(x.hi, e)
    return ds_norm(s, x.lo + err)


def ds_neg(x: DS) -> DS:
    return DS(-x.hi, -x.lo)


def ds_sub(x: DS, y: DS) -> DS:
    """Full accurate DS subtraction (the IR residual ``b - Ax``)."""
    s, e = two_sum(x.hi, -y.hi)
    t, f = two_sum(x.lo, -y.lo)
    s, e = fast_two_sum(s, e + t)
    return ds_norm(s, e + f)


def ds_where(c, x: DS, y: DS) -> DS:
    return DS(jnp.where(c, x.hi, y.hi), jnp.where(c, x.lo, y.lo))


def ds_dot_hi(x: DS, y: DS):
    """f32 dot of the hi parts (HIGHEST precision): used only for
    convergence *tests* on ||r||^2, where sqrt(N)*eps_f32 relative accuracy
    is ample — the decision threshold spans 16 orders of magnitude."""
    return jnp.dot(x.hi, y.hi, precision=jax.lax.Precision.HIGHEST)


# --------------------------------------------------------------------------
# banded Kronecker (separable) apply in DS — XLA reference implementation
# --------------------------------------------------------------------------

class SeparableDS:
    """DS twin of :class:`lpfem.operators.SeparableLattice`: the assembled
    f64 1D band factors are stored as DS pairs (capturing the true f64
    operator to ~2^-48), and ``apply3`` runs every banded contraction in
    compensated f32: exact products via pre-split Dekker ``two_prod``,
    exact accumulation via ``two_sum`` with the error flowing into the lo
    stream. Only the ``c.lo * u.lo`` cross term (~2^-48 relative) is
    dropped.

    It replaces the f64 outer operator of the mixed solve when
    ``hi_apply="ds"`` (``lpfem/surface.py`` solve_laplace).
    """

    def __init__(self, sep):
        # sep: a SeparableLattice whose band arrays are f64
        self.p = sep.p
        self.Dx, self.Dy, self.Dz = sep.Dx, sep.Dy, sep.Dz
        self.periodic = sep.periodic
        self.bands = {}
        for name in ("Kx", "Mx", "Ky", "My", "Kz", "Mz"):
            b64 = np.asarray(getattr(sep, name), dtype=np.float64)
            hi = b64.astype(np.float32)
            lo = (b64 - hi.astype(np.float64)).astype(np.float32)
            self.bands[name] = DS(jnp.asarray(hi), jnp.asarray(lo))

    def register_params(self, bp) -> None:
        # band tables are [2p+1, D] — small, but register the big ones
        for name, d in self.bands.items():
            setattr(self, f"_band_{name}_hi", d.hi)
            setattr(self, f"_band_{name}_lo", d.lo)
            bp.register(self, f"_band_{name}_hi", f"_band_{name}_lo")

    def _band(self, name: str) -> DS:
        # read through the (possibly params-threaded) attributes
        hi = getattr(self, f"_band_{name}_hi", None)
        if hi is not None:
            return DS(hi, getattr(self, f"_band_{name}_lo"))
        return self.bands[name]

    def _axis(self, u: DS, c: DS, axis: int) -> DS:
        """Compensated banded 1D contraction along ``axis``:
        y_i = sum_s c[p+s, i] * u_{i+s}."""
        p = self.p
        D = u.hi.shape[axis]
        shape = [1, 1, 1]
        shape[axis] = D
        # hoisted splits of the product operands
        uhh, uhl = split(u.hi)
        chh, chl = split(c.hi)
        per = self.periodic[2 - axis]

        def shifted(v):
            if per:
                return [jnp.roll(v, -s, axis) for s in range(-p, p + 1)]
            pad = [(0, 0)] * 3
            pad[axis] = (p, p)
            vp = jnp.pad(v, pad)
            return [jax.lax.slice_in_dim(vp, k, k + D, axis=axis)
                    for k in range(2 * p + 1)]

        su, suh, sul, slo = (shifted(u.hi), shifted(uhh), shifted(uhl),
                             shifted(u.lo))
        acc_h = None
        acc_l = None
        for k in range(2 * p + 1):
            ch = c.hi[k].reshape(shape)
            cl = c.lo[k].reshape(shape)
            chh_k = chh[k].reshape(shape)
            chl_k = chl[k].reshape(shape)
            pr, err = two_prod_presplit(ch, su[k], chh_k, chl_k,
                                        suh[k], sul[k])
            err = err + ch * slo[k] + cl * su[k]
            if acc_h is None:
                acc_h, acc_l = pr, err
            else:
                acc_h, t = two_sum(acc_h, pr)
                acc_l = acc_l + (t + err)
        return ds_norm(acc_h, acc_l)

    def _ds_add(self, x: DS, y: DS) -> DS:
        s, e = two_sum(x.hi, y.hi)
        return ds_norm(s, e + x.lo + y.lo)

    def apply3(self, u: DS) -> DS:
        """A u on the [Dz, Dy, Dx] lattice view, all stages DS."""
        t1 = self._axis(u, self._band("Kx"), 2)
        t2 = self._axis(u, self._band("Mx"), 2)
        a = self._ds_add(self._axis(t1, self._band("My"), 1),
                         self._axis(t2, self._band("Ky"), 1))
        b = self._axis(t2, self._band("My"), 1)
        return self._ds_add(self._axis(a, self._band("Mz"), 0),
                            self._axis(b, self._band("Kz"), 0))

    def apply(self, x: DS) -> DS:
        sh = (self.Dz, self.Dy, self.Dx)
        u = DS(x.hi.reshape(sh), x.lo.reshape(sh))
        y = self.apply3(u)
        return DS(y.hi.reshape(-1), y.lo.reshape(-1))

    def constrained_apply_top(self, x: DS) -> DS:
        """Identity rows/cols on the top z-plane (free-surface essential
        set), the DS twin of ``SeparableLattice.constrained_apply_top``."""
        sh = (self.Dz, self.Dy, self.Dx)
        uh = x.hi.reshape(sh)
        ul = x.lo.reshape(sh)
        u0 = DS(uh.at[-1].set(0.0), ul.at[-1].set(0.0))
        y = self.apply3(u0)
        yh = y.hi.at[-1].set(uh[-1])
        yl = y.lo.at[-1].set(ul[-1])
        return DS(yh.reshape(-1), yl.reshape(-1))
