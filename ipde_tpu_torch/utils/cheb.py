"""Chebyshev nodes, quadrature, and spectral operator matrices (host, numpy).

These are geometry-static precomputations: everything here is built once in
float64 numpy at setup time and shipped to device as plain matrices.
Functional parity targets: reference ipde/utilities.py:36-49 (nodes),
ipde/embedded_boundary.py:21-36 (Fejer-1 weights), ipde/annular/annular.py:7-50
(ChebyshevOperators).
"""

from __future__ import annotations

import numpy as np


def chebyshev_gauss_nodes(n: int) -> np.ndarray:
    """Chebyshev points of the first kind on [-1, 1], ascending."""
    return -np.cos(np.pi * (np.arange(n) + 0.5) / n)


def get_chebyshev_nodes(lb: float, ub: float, order: int):
    """Ascending first-kind Chebyshev nodes scaled to [lb, ub].

    Returns (unscaled nodes, scaled nodes, scaling ratio) where
    ratio = (ub - lb) / 2 maps derivative d/dx_unscaled -> d/dx_scaled.
    """
    xc = chebyshev_gauss_nodes(order)
    rat = (ub - lb) / 2.0
    x = (xc + 1.0) * rat + lb
    return xc, x, rat


def fejer_1_weights(n: int) -> np.ndarray:
    """Fejer's first quadrature rule weights for first-kind Chebyshev nodes.

    Direct cosine-sum formula:
        w_j = (2/n) * (1 - 2 sum_{m=1}^{floor(n/2)} cos(2 m theta_j)/(4m^2-1)),
    theta_j = (2j+1) pi / (2n).  Integrates over [-1, 1].
    """
    j = np.arange(n)
    theta = (2 * j + 1) * np.pi / (2 * n)
    m = np.arange(1, n // 2 + 1)
    s = np.cos(2.0 * np.outer(theta, m)) / (4.0 * m**2 - 1.0)
    return (2.0 / n) * (1.0 - 2.0 * s.sum(axis=1))


def chebvander(x: np.ndarray, deg: int) -> np.ndarray:
    return np.polynomial.chebyshev.chebvander(x, deg)


def chebyshev_differentiation_matrix(n: int, rat: float = 1.0) -> np.ndarray:
    """n x n differentiation matrix on ascending first-kind nodes scaled by rat."""
    xc = chebyshev_gauss_nodes(n)
    V = chebvander(xc, n - 1)
    VI = np.linalg.inv(V)
    Dcoef = np.polynomial.chebyshev.chebder(np.eye(n)) / rat  # (n-1, n)
    Dcoef = np.vstack([Dcoef, np.zeros(n)])
    return V @ Dcoef @ VI


class ChebyshevOperators:
    """Chebyshev-tau operator set for the annular solvers.

    Grids of sizes M, M-1, M-2 (ascending first-kind nodes); operators map
    nodal values between them:
      D01 : differentiate, M -> M-1 nodes      D12 : M-1 -> M-2
      D00 : differentiate on the M grid (rank-deficient tau form)
      R01, R12, R02 : rank-reduction (projection) between grids
      P10 : prolongation M-1 -> M
      ibc_* / obc_* : end-point evaluation rows at x=+1 (inner) / x=-1 (outer)
    Reference semantics: ipde/annular/annular.py:7-50.  Note the reference
    labels x=+1 as the *inner* BC row; we keep that convention: the radial
    coordinate runs over [-width, 0] for interior problems with ascending
    Chebyshev nodes, so x=+1 corresponds to r=0 (the boundary side).
    """

    def __init__(self, M: int, rat: float):
        self.M = M
        self.rat = rat
        x0 = chebyshev_gauss_nodes(M)
        x1 = chebyshev_gauss_nodes(M - 1)
        x2 = chebyshev_gauss_nodes(M - 2)
        V0 = chebvander(x0, M - 1)
        V1 = chebvander(x1, M - 2)
        V2 = chebvander(x2, M - 3)
        VI0 = np.linalg.inv(V0)
        VI1 = np.linalg.inv(V1)
        VI2 = np.linalg.inv(V2)
        self.V0, self.V1, self.V2 = V0, V1, V2
        self.VI0, self.VI1, self.VI2 = VI0, VI1, VI2
        D01c = np.polynomial.chebyshev.chebder(np.eye(M)) / rat       # (M-1, M)
        D12c = np.polynomial.chebyshev.chebder(np.eye(M - 1)) / rat   # (M-2, M-1)
        D00c = np.vstack([D01c, np.zeros(M)])
        self.D00 = V0 @ D00c @ VI0
        self.D01 = V1 @ D01c @ VI0
        self.D12 = V2 @ D12c @ VI1
        # endpoint evaluation rows (1, M)
        self.ibc_dirichlet = chebvander(np.array([1.0]), M - 1) @ VI0
        self.obc_dirichlet = chebvander(np.array([-1.0]), M - 1) @ VI0
        self.ibc_neumann = self.ibc_dirichlet @ self.D00
        self.obc_neumann = self.obc_dirichlet @ self.D00
        # rank reduction operators
        T01 = np.eye(M - 1, M)
        T12 = np.eye(M - 2, M - 1)
        self.R01 = V1 @ T01 @ VI0
        self.R12 = V2 @ T12 @ VI1
        self.R02 = self.R12 @ self.R01
        # prolongation M-1 -> M
        T10 = np.eye(M, M - 1)
        self.P10 = V0 @ T10 @ VI1
