"""The eight Cell-benchmark programs (paper §4.1), as CMM expressions.

Each function returns the root ClusteredMatrix of a matmul-dominant
expression over n x n inputs (Markov, K-Means, Hill, Leontief, DFT, Synth,
Reachability, Hits), transcribed from the JAX reference's
``benchmarks/cmm_suite.py``.  ``dtype`` sets the leaves' type (the
reference's functions are f64 only).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from .core.lazy import ClusteredMatrix as CM


def markov(n: int, seed: int = 0, dtype=torch.float64) -> CM:
    """Fig. 2: u' = P^3 u (random-walk distribution after 3 steps)."""
    P = CM.rand(n, n, seed=seed, dtype=dtype, name="P")
    u = CM.rand(n, 1, seed=seed + 1, dtype=dtype, name="u")
    return (P @ P @ P) @ u


def kmeans(n: int, seed: int = 0, dtype=torch.float64) -> CM:
    """Distance/assignment core: E = X C^T, A = relu-threshold, C' = A^T X."""
    X = CM.rand(n, n, seed=seed, dtype=dtype, name="X")
    Ct = CM.rand(n, n, seed=seed + 1, dtype=dtype, name="Ct")
    E = X @ Ct
    A = (E - 0.5).relu()
    return A.T @ X


def hill(n: int, seed: int = 0, dtype=torch.float64) -> CM:
    """Hill cipher: encrypt C = K P, decrypt P' = K' C, residual P' - P."""
    K = CM.rand(n, n, seed=seed, dtype=dtype, name="K")
    Kinv = CM.rand(n, n, seed=seed + 1, dtype=dtype, name="Kinv")
    P = CM.rand(n, n, seed=seed + 2, dtype=dtype, name="P")
    C = K @ P
    P2 = Kinv @ C
    return P2 - P


def leontief(n: int, seed: int = 0, dtype=torch.float64) -> CM:
    """x = (I + A + A^2 + A^3) d — Neumann series for (I-A)^-1 d."""
    A = CM.rand(n, n, seed=seed, dtype=dtype, name="A") * (1.0 / n)
    d = CM.rand(n, 1, seed=seed + 1, dtype=dtype, name="d")
    A2 = A @ A
    A3 = A2 @ A
    return d + (A @ d) + (A2 @ d) + (A3 @ d)


def dft(n: int, seed: int = 0, dtype=torch.float64) -> CM:
    """Matrix DFT: Y = F X (+ inverse pass F' Y), F dense n x n."""
    F = CM.rand(n, n, seed=seed, dtype=dtype, name="F")
    Fi = CM.rand(n, n, seed=seed + 1, dtype=dtype, name="Fi")
    X = CM.rand(n, n, seed=seed + 2, dtype=dtype, name="X")
    Y = F @ X
    return (Fi @ Y) * (1.0 / n)


def synth(n: int, seed: int = 0, dtype=torch.float64) -> CM:
    """Synthetic: two independent products mixed — embarrassingly parallel
    (the paper's best-scaling benchmark)."""
    A = CM.rand(n, n, seed=seed, dtype=dtype, name="A")
    B = CM.rand(n, n, seed=seed + 1, dtype=dtype, name="B")
    C = CM.rand(n, n, seed=seed + 2, dtype=dtype, name="C")
    D = CM.rand(n, n, seed=seed + 3, dtype=dtype, name="D")
    return (A @ B) + (C @ D)


def reachability(n: int, seed: int = 0, dtype=torch.float64) -> CM:
    """Transitive-closure steps: R1 = sgn(A^2 + A), R2 = sgn(R1^2 + R1)."""
    A = CM.rand(n, n, seed=seed, dtype=dtype, name="A")
    R1 = ((A @ A) + A).ewise("sign")
    return ((R1 @ R1) + R1).ewise("sign")


def hits(n: int, seed: int = 0, dtype=torch.float64) -> CM:
    """HITS: two authority/hub iterations a = A^T(A a), h = A(A^T h)."""
    A = CM.rand(n, n, seed=seed, dtype=dtype, name="A")
    a = CM.rand(n, 1, seed=seed + 1, dtype=dtype, name="a")
    h = CM.rand(n, 1, seed=seed + 2, dtype=dtype, name="h")
    a1 = A.T @ (A @ a)
    h1 = A @ (A.T @ h)
    return (A.T @ (A @ a1)) + (A @ (A.T @ h1))


BENCHMARKS: Dict[str, Callable[..., CM]] = {
    "Markov": markov,
    "Kmeans": kmeans,
    "Hill": hill,
    "Leontief": leontief,
    "DFT": dft,
    "Synth": synth,
    "Reachability": reachability,
    "Hits": hits,
}
