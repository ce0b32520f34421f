"""PCA+ICA whitening (port of ``PCAICAWhiteningModel`` from
``rag_cobweb_tpu/whitening/models.py``).

The fit is host numpy in float64, copied from the JAX package, so both
packages fit the same model.  ``transform_torch`` is the device transform:
center -> project -> scale -> unmix precomposed into one (d_in, d_out)
matrix ``M`` and bias ``b``, applied as one product accumulated in float64
and rounded once to float32, so the card and the host give the same rows
(a float32 product rounds in each device's summation order, and the
tree's near-tie decisions see a last-bit difference).
``save``/``load`` use the JAX package's pickle layout (a dict of numpy
arrays), so either package loads the other's file.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from rag_cobweb_tpu_torch.whitening.fastica import fastica


def _pca_fit(X: np.ndarray, pca_dim):
    """Host-precision PCA: (mean, components (k, d), explained_var (k,)).
    ``pca_dim``: int -> k components; float in (0, 1) -> the smallest k
    whose cumulative explained-variance ratio reaches it."""
    X = np.asarray(X, np.float64)
    mean = X.mean(axis=0)
    Xc = X - mean
    n = X.shape[0]
    cov = (Xc.T @ Xc) / (n - 1)
    eigvals, eigvecs = np.linalg.eigh(cov)
    order = np.argsort(eigvals)[::-1]
    eigvals = np.maximum(eigvals[order], 0.0)
    eigvecs = eigvecs[:, order]
    if isinstance(pca_dim, float):
        if not 0.0 < pca_dim < 1.0:
            raise ValueError(f"fractional pca_dim must be in (0,1): {pca_dim}")
        ratio = np.cumsum(eigvals) / max(eigvals.sum(), 1e-30)
        k = int(np.searchsorted(ratio, pca_dim) + 1)
    else:
        k = int(pca_dim)
    k = max(1, min(k, X.shape[1], n))
    return mean, eigvecs[:, :k].T, eigvals[:k]


class PCAICAWhiteningModel:
    """PCA -> normalize by sqrt(eigenvalue) -> ICA rotation."""

    def __init__(self, mean, pca_components, ica_unmixing,
                 pca_explained_var, eps: float = 1e-8):
        self.mean = np.asarray(mean)
        self.pca_components = np.asarray(pca_components)
        self.pca_explained_var = np.asarray(pca_explained_var)
        self.ica_unmixing = np.asarray(ica_unmixing)
        self.eps = eps
        self._torch_cache: dict = {}

    @property
    def dim_out(self) -> int:
        return self.ica_unmixing.shape[0]

    def transform(self, x, is_ica: bool = True) -> np.ndarray:
        """Whiten one embedding or a batch on the host (numpy in and out)."""
        x = np.asarray(x)
        single = x.ndim == 1
        if single:
            x = x[None, :]
        x_pca = (x - self.mean) @ self.pca_components.T
        x_pca = x_pca / np.sqrt(self.pca_explained_var + self.eps)
        out = x_pca @ self.ica_unmixing.T if is_ica else x_pca
        out = out.astype(np.float32)
        return out[0] if single else out

    def affine(self, dtype=np.float32):
        """The precomposed transform ``(M (d_in, d_out), b)`` in ``dtype``
        (computed in float64)."""
        scale = 1.0 / np.sqrt(self.pca_explained_var + self.eps)
        M = (self.pca_components.T * scale[None, :]) @ self.ica_unmixing.T
        b = -(self.mean @ M)
        return M.astype(dtype), b.astype(dtype)

    def transform_torch(self, x: torch.Tensor) -> torch.Tensor:
        """Device transform of a (B, d_in) tensor: ``x @ M + b`` with
        ``M``, ``b`` and the sums in float64, the result rounded to
        float32: the same rows on every device."""
        key = str(x.device)
        if key not in self._torch_cache:
            M, b = self.affine(np.float64)
            self._torch_cache[key] = (torch.as_tensor(M, device=x.device),
                                      torch.as_tensor(b, device=x.device))
        M, b = self._torch_cache[key]
        return (torch.matmul(x.double(), M) + b).float()

    @classmethod
    def fit(cls, X, pca_dim=256, eps: float = 1e-8,
            ica_max_iter: int = 5000, ica_tol: float = 1e-3, seed: int = 0,
            ica_sample_size: int = 20000):
        """PCA -> unit-variance normalize -> FastICA; above
        ``ica_sample_size`` rows the ICA stage fits on a random subsample."""
        mean, components, explained_var = _pca_fit(X, pca_dim)
        Xp = (np.asarray(X, np.float64) - mean) @ components.T
        Xp = Xp / np.sqrt(explained_var + eps)
        if ica_sample_size and len(Xp) > ica_sample_size:
            sel = np.random.default_rng(seed).choice(
                len(Xp), ica_sample_size, replace=False)
            Xp = Xp[sel]
        res = fastica(Xp, n_components=components.shape[0],
                      max_iter=ica_max_iter, tol=ica_tol, seed=seed)
        return cls(mean, components, res.components, explained_var, eps)

    def save(self, filepath: str):
        with open(filepath, "wb") as f:
            pickle.dump({
                "mean": self.mean,
                "pca_components": self.pca_components,
                "pca_explained_var": self.pca_explained_var,
                "ica_unmixing": self.ica_unmixing,
                "eps": self.eps,
            }, f)

    @classmethod
    def load(cls, filepath: str):
        with open(filepath, "rb") as f:
            d = pickle.load(f)
        return cls(d["mean"], d["pca_components"], d["ica_unmixing"],
                   d["pca_explained_var"], d["eps"])
