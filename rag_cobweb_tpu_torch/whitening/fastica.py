"""Native FastICA (no sklearn): parallel (symmetric) fixed-point iteration
with the logcosh contrast, matching the configuration the reference requests
from sklearn (pca_ica.py:72-74 — whiten='unit-variance', max_iter=5000,
tol=1e-3).

Host numpy in float64: fitting is a one-time cost and the fixed-point
iteration is precision-sensitive.  A copy of ``fastica`` from
``rag_cobweb_tpu/whitening/fastica.py`` (its device variant is not
carried), so both packages fit the same model from the same data.

It returns an unmixing matrix W_full such that
``S = (X - mean) @ W_full.T`` has unit-variance, maximally non-Gaussian
components.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class FastICAResult(NamedTuple):
    components: np.ndarray   # (k, d) full unmixing (incl. whitening)
    mean: np.ndarray         # (d,)
    n_iter: int
    converged: bool


def _sym_decorrelation(W: np.ndarray) -> np.ndarray:
    """W <- (W W^T)^{-1/2} W (symmetric decorrelation)."""
    s, u = np.linalg.eigh(W @ W.T)
    s = np.maximum(s, 1e-12)
    return (u * (1.0 / np.sqrt(s))) @ u.T @ W


def fastica(X: np.ndarray, n_components: int | None = None,
            max_iter: int = 5000, tol: float = 1e-3,
            seed: int = 0) -> FastICAResult:
    """Fit ICA on data X (n_samples, d).  Whitens internally to unit
    variance, then runs parallel FastICA with g = tanh (logcosh contrast)."""
    X = np.asarray(X, np.float64)
    n, d = X.shape
    k = n_components or d
    mean = X.mean(axis=0)
    Xc = X - mean

    # unit-variance whitening via SVD
    U, S, Vt = np.linalg.svd(Xc, full_matrices=False)
    S = np.maximum(S, 1e-12)
    K = (Vt[:k] / S[:k, None]) * np.sqrt(n - 1)   # (k, d): whitening matrix
    Xw = Xc @ K.T                                  # (n, k), unit variance

    rng = np.random.default_rng(seed)
    W = _sym_decorrelation(rng.normal(size=(k, k)))

    converged = False
    it = 0
    for it in range(max_iter):
        WX = Xw @ W.T                 # (n, k) current source estimates
        G = np.tanh(WX)
        G_prime = 1.0 - G * G
        W_new = (G.T @ Xw) / n - np.diag(G_prime.mean(axis=0)) @ W
        W_new = _sym_decorrelation(W_new)
        # convergence: rotation distance of each component
        lim = np.max(np.abs(np.abs(np.einsum("ij,ij->i", W_new, W)) - 1.0))
        W = W_new
        if lim < tol:
            converged = True
            break

    components = W @ K                # (k, d) full unmixing
    return FastICAResult(components, mean, it + 1, converged)
