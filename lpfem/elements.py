"""High-order H1 Lagrange (spectral) elements on tensor-product cells.

Replacement for MFEM's ``H1_FECollection`` (reference:
``Solvers/laplace_solver_parallel_partial.cpp:95`` uses p up to 10) and the 1D
basis machinery behind MFEM's sum-factorized partial assembly
(``AssemblyLevel::PARTIAL``, ``Solvers/PF_linear_par_partial.cpp:118-121``).

Everything here is small, host-side NumPy, computed once per (order, nquad)
pair: Gauss-Lobatto-Legendre nodes (MFEM's default H1 node placement),
Gauss-Legendre quadrature, and the dense 1D interpolation / differentiation
matrices that the device kernels contract with.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "gauss_legendre",
    "gauss_lobatto_nodes",
    "lagrange_eval",
    "Basis1D",
    "basis_1d",
]


def gauss_legendre(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [0, 1]. Exact to degree 2n-1."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def gauss_lobatto_nodes(p: int) -> np.ndarray:
    """p+1 Gauss-Lobatto-Legendre points on [0, 1] (includes endpoints).

    These are the H1 Lagrange node locations (MFEM ``BasisType::GaussLobatto``,
    the default for ``H1_FECollection``). Interior nodes are the roots of
    P'_p (derivative of the Legendre polynomial of degree p).
    """
    if p == 0:
        return np.array([0.5])
    if p == 1:
        return np.array([0.0, 1.0])
    # Roots of P'_p via eigenvalues of the Jacobi matrix of the (1,1) Jacobi
    # polynomials; equivalently use numpy's Legendre derivative roots.
    legp = np.polynomial.legendre.Legendre.basis(p)
    interior = legp.deriv().roots()
    pts = np.concatenate(([-1.0], np.sort(interior.real), [1.0]))
    return (pts + 1.0) / 2.0


def lagrange_eval(nodes: np.ndarray, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Evaluate the Lagrange basis through ``nodes`` at points ``x``.

    Returns ``(B, D)`` with shapes ``[len(x), len(nodes)]``:
    ``B[q, i] = l_i(x_q)`` and ``D[q, i] = l_i'(x_q)``.

    Uses the barycentric form for stability at high order (p=10 is in scope,
    reference ``Solvers/laplace_solver_parallel_partial.cpp:95``).
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = len(nodes)
    # Barycentric weights
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    wbar = 1.0 / np.prod(diff, axis=1)

    B = np.zeros((len(x), n))
    D = np.zeros((len(x), n))
    for q, xq in enumerate(x):
        d = xq - nodes
        exact = np.where(np.abs(d) < 1e-14)[0]
        if len(exact):
            i = exact[0]
            B[q, i] = 1.0
            # l_i'(x_i) and l_j'(x_i) closed forms via barycentric weights
            for j in range(n):
                if j != i:
                    D[q, j] = (wbar[j] / wbar[i]) / (nodes[i] - nodes[j])
            D[q, i] = -np.sum(D[q, np.arange(n) != i])
        else:
            c = wbar / d
            s = np.sum(c)
            B[q] = c / s
            # derivative of barycentric form
            sp = np.sum(c / d)
            D[q] = (B[q] * sp - c / d) / s
    return B, D


class Basis1D:
    """1D basis data for order ``p`` with ``q`` quadrature points.

    Attributes (all float64 NumPy, shapes noted):
      nodes   [p+1]     GLL node locations on [0,1]
      qpts    [q]       Gauss-Legendre quadrature points on [0,1]
      qwts    [q]       quadrature weights
      B       [q, p+1]  basis values at quadrature points
      D       [q, p+1]  basis derivatives at quadrature points
      Bn      [p+1,p+1] basis values at the nodes (identity)
      Dn      [p+1,p+1] basis derivatives at the nodes (spectral diff matrix)
    """

    def __init__(self, p: int, q: int | None = None):
        if q is None:
            q = p + 1
        self.p = p
        self.q = q
        self.nodes = gauss_lobatto_nodes(p)
        self.qpts, self.qwts = gauss_legendre(q)
        self.B, self.D = lagrange_eval(self.nodes, self.qpts)
        self.Bn, self.Dn = lagrange_eval(self.nodes, self.nodes)


@functools.lru_cache(maxsize=None)
def basis_1d(p: int, q: int | None = None) -> Basis1D:
    return Basis1D(p, q)
