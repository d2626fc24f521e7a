"""Exact Toom-Cook / Winograd matrix construction.

The port's own copy of the JAX package's numpy-only module of the same
name (``repro_torch`` imports nothing of ``repro``).

Builds the bilinear-algorithm matrices ``(AT, G, BT)`` for the DNN
"valid correlation" form ``F(m, r)``: ``m`` outputs from a length
``n = m + r - 1`` input tile and a length-``r`` kernel::

    y = AT @ ((G @ g) * (BT @ d))          # * is the Hadamard product

Derivation: Toom-Cook evaluates the two factor polynomials of a linear
convolution at ``n`` interpolation points (one of which may be the point
at infinity), multiplies pointwise, and interpolates back.  The
Matrix Exchange (transposition) Theorem turns the linear-convolution
algorithm ``h = C (V_m u ⊙ V_r v)`` into the correlation algorithm
``y = V_mᵀ ((V_r g) ⊙ (Cᵀ d))``, which is the form DNN convolution needs.

Everything here is exact rational arithmetic (``fractions.Fraction``);
floats are produced only at the very edge via :func:`to_float`.  The
Lagrange denominators are folded into ``G`` (the kernel transform), the
convention used by Lavin & Gray's ``wincnn`` and by Barabasz et al.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Sequence, Union

import numpy as np

__all__ = [
    "INF",
    "default_points",
    "toom_cook_matrices",
    "to_float",
    "row_l1_norms",
    "max_row_l1",
    "mults_per_output_2d",
]

# The point at infinity: evaluating a degree-(d-1) polynomial "at infinity"
# yields its leading coefficient. Using it saves one finite point and gives
# the familiar [0, ..., 0, 1] rows.
INF = "inf"

Point = Union[int, Fraction, str]


def _as_fraction(p: Point) -> Fraction:
    if isinstance(p, Fraction):
        return p
    if isinstance(p, int):
        return Fraction(p)
    raise TypeError(f"not a finite point: {p!r}")


def default_points(m: int, r: int) -> list[Point]:
    """Good default interpolation points for F(m, r).

    The small sets follow Barabasz, Anderson, Soodhalter & Gregg (2018),
    "Error analysis and improving the accuracy of Winograd convolution",
    which searched for point sets minimising the fp error.  The point at
    infinity is always used (it costs nothing and zeroes a row).
    """
    n = m + r - 1
    n_finite = n - 1
    curated = {
        1: [0],
        2: [0, -1],
        3: [0, -1, 1],
        4: [0, -1, 1, Fraction(1, 2)],
        5: [0, -1, 1, Fraction(1, 2), -2],
        6: [0, -1, 1, Fraction(1, 2), -2, -Fraction(1, 2)],
        7: [0, -1, 1, Fraction(1, 2), -Fraction(1, 2), 2, -2],
        8: [0, -1, 1, Fraction(1, 2), -Fraction(1, 2), 2, -2, Fraction(1, 4)],
    }
    if n_finite in curated:
        return list(curated[n_finite]) + [INF]
    # Generic fallback: 0, ±1, ±1/2, ±2, ±1/4, ±4, ... reciprocal pairs keep
    # the Vandermonde growth balanced.
    pts: list[Point] = [0]
    k = 0
    while len(pts) < n_finite:
        k += 1
        base = Fraction(2) ** ((k + 1) // 2) if k % 2 else 1 / (Fraction(2) ** (k // 2))
        for cand in (base, -base):
            if len(pts) < n_finite and cand not in pts:
                pts.append(cand)
    return pts + [INF]


def _poly_mul(a: list[Fraction], b: list[Fraction]) -> list[Fraction]:
    out = [Fraction(0)] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                out[i + j] += ai * bj
    return out


def _monic_from_roots(roots: Sequence[Fraction]) -> list[Fraction]:
    """Coefficients (low→high degree) of Π (x - root)."""
    poly = [Fraction(1)]
    for rt in roots:
        poly = _poly_mul(poly, [-rt, Fraction(1)])
    return poly


def toom_cook_matrices(
    m: int, r: int, points: Sequence[Point] | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact (AT, G, BT) for F(m, r) as object-dtype Fraction arrays.

    Shapes: ``AT (m, n)``, ``G (n, r)``, ``BT (n, n)`` with ``n = m+r-1``.
    ``y = AT @ ((G @ g) * (BT @ d))`` equals the valid correlation of the
    length-``n`` input ``d`` with the length-``r`` kernel ``g`` exactly.
    """
    n = m + r - 1
    if points is None:
        points = default_points(m, r)
    if len(points) != n:
        raise ValueError(f"F({m},{r}) needs {n} points, got {len(points)}")
    use_inf = INF in points
    if use_inf:
        if points[-1] != INF or points.count(INF) != 1:
            raise ValueError("the point at infinity must appear exactly once, last")
        finite = [_as_fraction(p) for p in points[:-1]]
    else:
        finite = [_as_fraction(p) for p in points]
    if len(set(finite)) != len(finite):
        raise ValueError("interpolation points must be distinct")

    n_f = len(finite)

    # Evaluation Vandermondes. Row i evaluates a polynomial (coeff vector,
    # low->high) at point i; the infinity row picks the leading coefficient.
    def eval_matrix(n_cols: int) -> np.ndarray:
        M = np.empty((n, n_cols), dtype=object)
        for i, p in enumerate(finite):
            acc = Fraction(1)
            for j in range(n_cols):
                M[i, j] = acc
                acc *= p
        if use_inf:
            for j in range(n_cols):
                M[n_f, j] = Fraction(1) if j == n_cols - 1 else Fraction(0)
        return M

    V_m = eval_matrix(m)  # evaluates the length-m factor
    V_r = eval_matrix(r)  # evaluates the length-r factor (kernel)

    # Interpolation matrix C (n x n): values-at-points -> coefficients of the
    # degree-(n-1) product polynomial. Lagrange denominators are folded into
    # G's rows, so C's columns hold only the *numerator* polynomials.
    C = np.zeros((n, n), dtype=object)
    for i in range(n):
        for j in range(n):
            C[i, j] = Fraction(0)
    denoms = []
    for i, p in enumerate(finite):
        num = _monic_from_roots([q for k, q in enumerate(finite) if k != i])
        den = Fraction(1)
        for k, q in enumerate(finite):
            if k != i:
                den *= p - q
        if use_inf:
            # h(x) = Σ_i h(p_i)·[ℓ_i(x) - ℓ_i,top·M(x)] + h_top·M(x); with the
            # monic M(x) = Π(x - p_i) of degree n-1 and deg ℓ_i = n-2 the
            # correction term vanishes: column i is just the numerator of ℓ_i.
            for j, c in enumerate(num):
                C[j, i] = c
        else:
            for j, c in enumerate(num):
                C[j, i] = c
        denoms.append(den)
    if use_inf:
        M_poly = _monic_from_roots(finite)  # degree n-1, n coefficients
        for j, c in enumerate(M_poly):
            C[j, n_f] = c
        denoms.append(Fraction(1))

    # Fold 1/denominator into G (scale freedom of the bilinear algorithm).
    G = np.empty((n, r), dtype=object)
    for i in range(n):
        for j in range(r):
            G[i, j] = V_r[i, j] / denoms[i]

    AT = V_m.T.copy()
    BT = C.T.copy()
    return AT, G, BT


def to_float(M: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Convert an object/Fraction matrix to floating point."""
    return np.array([[float(x) for x in row] for row in M], dtype=dtype)


def row_l1_norms(M: np.ndarray) -> list[Fraction]:
    """Exact per-row L1 norms of an object/Fraction matrix.

    The worst-case amplification framework of Barabasz et al. 2018: for
    a linear stage ``y = M x`` with ``|x_i| <= a``, the tight worst-case
    bound is ``|y_i| <= a * Σ_j |M_ij|`` — attained by the sign-aligned
    input ``x_j = a * sign(M_ij)``. These norms are THE inputs to the
    static range certifier of the JAX package; keeping them in
    exact rational arithmetic means the certified bounds inherit the
    exactness of the transform construction above.
    """
    return [sum((abs(Fraction(x)) for x in row), Fraction(0)) for row in M]


def max_row_l1(M: np.ndarray) -> Fraction:
    """Exact max per-row L1 norm — the matrix's worst-case amplification
    factor as an operator on the max-norm ball (see ``row_l1_norms``)."""
    return max(row_l1_norms(M))


def mults_per_output_2d(m: int, r: int) -> float:
    """General multiplications per output point for 2-D F(m×m, r×r)."""
    n = m + r - 1
    return (n * n) / float(m * m)
