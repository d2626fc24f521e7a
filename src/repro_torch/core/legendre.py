"""Polynomial base-change matrices (canonical -> Legendre / Chebyshev).

The port's own copy of the JAX package's numpy-only module of the same
name (``repro_torch`` imports nothing of ``repro``).

The paper performs the Winograd transforms in a *monic ("normalised")
Legendre* polynomial basis.  ``PT = legendre_PT(n)`` is the n×n matrix whose
row ``i`` holds the canonical coefficients (low→high degree) of the monic
Legendre polynomial ``L̃_i``; for n = 6 it reproduces the paper's printed
``Pᵀ`` exactly::

    PT[2] = [-1/3, 0, 1, 0, 0, 0]            # L̃₂ = x² − 1/3
    PT[5] = [0, 5/21, 0, -10/9, 0, 1]        # L̃₅ = x⁵ − 10/9·x³ + 5/21·x

All arithmetic is exact (``fractions.Fraction``).  The base-change matrices
are triangular with unit diagonal, so their exact inverses exist and are
computed here by back-substitution.  ``P`` is sparse: 6 off-diagonal
non-zeros at n = 6 (paper §4.1).
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np

__all__ = [
    "monic_legendre_coeffs",
    "monic_chebyshev_coeffs",
    "legendre_PT",
    "chebyshev_PT",
    "invert_unitriangular",
    "base_change",
]


def monic_legendre_coeffs(n: int) -> list[list[Fraction]]:
    """Canonical coefficients (low→high) of monic Legendre L̃_0 .. L̃_{n-1}.

    Standard Legendre recurrence (k+1)·P_{k+1} = (2k+1)·x·P_k − k·P_{k-1};
    monic normalisation divides by the leading coefficient
    c_k = (2k)! / (2^k (k!)²).
    """
    if n < 1:
        raise ValueError(n)
    polys = [[Fraction(1)]]
    if n == 1:
        return polys
    polys.append([Fraction(0), Fraction(1)])
    for k in range(1, n - 1):
        # (k+1) P_{k+1} = (2k+1) x P_k - k P_{k-1}  on standard Legendre.
        pk, pk1 = polys[k], polys[k - 1]
        nxt = [Fraction(0)] * (k + 2)
        for j, c in enumerate(pk):
            nxt[j + 1] += Fraction(2 * k + 1, k + 1) * c
        for j, c in enumerate(pk1):
            nxt[j] -= Fraction(k, k + 1) * c
        polys.append(nxt)
    # polys currently hold *standard* Legendre only if we had started from
    # standard P_1 = x (we did) — the recurrence keeps them standard.
    # Normalise each to monic.
    monic = []
    for poly in polys:
        lead = poly[-1]
        monic.append([c / lead for c in poly])
    return monic


def monic_chebyshev_coeffs(n: int) -> list[list[Fraction]]:
    """Canonical coefficients of monic Chebyshev T̃_0..T̃_{n-1} (T̃_k = T_k/2^{k-1})."""
    if n < 1:
        raise ValueError(n)
    polys = [[Fraction(1)]]
    if n == 1:
        return polys
    polys.append([Fraction(0), Fraction(1)])
    for k in range(1, n - 1):
        # T_{k+1} = 2x T_k - T_{k-1}
        pk, pk1 = polys[k], polys[k - 1]
        nxt = [Fraction(0)] * (k + 2)
        for j, c in enumerate(pk):
            nxt[j + 1] += 2 * c
        for j, c in enumerate(pk1):
            nxt[j] -= c
        polys.append(nxt)
    return [[c / poly[-1] for c in poly] for poly in polys]


def _coeffs_to_PT(coeffs: list[list[Fraction]]) -> np.ndarray:
    n = len(coeffs)
    PT = np.empty((n, n), dtype=object)
    for i in range(n):
        for j in range(n):
            PT[i, j] = coeffs[i][j] if j < len(coeffs[i]) else Fraction(0)
    return PT


def legendre_PT(n: int) -> np.ndarray:
    """The paper's Pᵀ: rows are monic-Legendre canonical coefficients."""
    return _coeffs_to_PT(monic_legendre_coeffs(n))


def chebyshev_PT(n: int) -> np.ndarray:
    """Beyond-paper alternative basis: monic Chebyshev."""
    return _coeffs_to_PT(monic_chebyshev_coeffs(n))


def invert_unitriangular(M: np.ndarray) -> np.ndarray:
    """Exact inverse of a (possibly permuted-)triangular unit-diagonal matrix.

    Gauss-Jordan in Fraction arithmetic — exact for any invertible rational
    matrix, cheap at the 4–8 sizes used here.
    """
    n = M.shape[0]
    A = np.empty((n, 2 * n), dtype=object)
    for i in range(n):
        for j in range(n):
            A[i, j] = Fraction(M[i, j])
            A[i, n + j] = Fraction(1) if i == j else Fraction(0)
    for col in range(n):
        piv = next(i for i in range(col, n) if A[i, col] != 0)
        if piv != col:
            A[[col, piv]] = A[[piv, col]]
        pv = A[col, col]
        for j in range(2 * n):
            A[col, j] = A[col, j] / pv
        for i in range(n):
            if i != col and A[i, col] != 0:
                f = A[i, col]
                for j in range(2 * n):
                    A[i, j] = A[i, j] - f * A[col, j]
    return A[:, n:].copy()


def base_change(n: int, base: str = "legendre") -> tuple[np.ndarray, np.ndarray]:
    """Return exact (P, Pinv) for the requested basis, n×n.

    ``P = PTᵀ`` where PT rows hold the basis polynomials' canonical
    coefficients (the paper's orientation: G_P = P·G etc.).
    """
    if base == "canonical":
        I = np.empty((n, n), dtype=object)
        for i in range(n):
            for j in range(n):
                I[i, j] = Fraction(1) if i == j else Fraction(0)
        return I, I.copy()
    if base == "legendre":
        PT = legendre_PT(n)
    elif base == "chebyshev":
        PT = chebyshev_PT(n)
    else:
        raise ValueError(f"unknown base {base!r}")
    P = PT.T.copy()
    return P, invert_unitriangular(P)
