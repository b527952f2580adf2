"""Eigendecomposition of reversible rate matrices.

Equivalent of the reference's PAML-derived eigenQREV / computePMatrix
(src/utils/eigen.cpp:330-358, src/utils/model_factory.cpp:1809-1894), but
done the numpy way: a reversible Q with stationary distribution pi is
similar to the symmetric matrix  S = D Q D^{-1}  with D = diag(sqrt(pi)),
so  Q = U diag(lam) V  with  U = D^{-1} R,  V = R^T D  for the orthonormal
eigenvectors R of S.  P(t) = U exp(lam t) V, computed densely (a matrix
product when jitted).
"""
from __future__ import annotations

import numpy as np


def eigen_qrev(q: np.ndarray, pi: np.ndarray):
    """Return (lam, U, V) such that q = U @ diag(lam) @ V.

    Matches eigenQREV's output contract: real eigenvalues, U/V inverse
    pair scaled by sqrt(pi).
    """
    q = np.asarray(q, dtype=np.float64)
    pi = np.asarray(pi, dtype=np.float64)
    sq = np.sqrt(pi)
    s = (sq[:, None] * q) / sq[None, :]
    s = 0.5 * (s + s.T)  # symmetrise against rounding in the inputs
    lam, r = np.linalg.eigh(s)
    u = r / sq[:, None]
    v = r.T * sq[None, :]
    return lam, u, v


def p_matrix(lam: np.ndarray, u: np.ndarray, v: np.ndarray,
             t: float) -> np.ndarray:
    """P(t) = U exp(lam t) V (reference: eigen.cpp:330-358, no clamping)."""
    return (u * np.exp(lam * t)[None, :]) @ v
