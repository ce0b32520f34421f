"""Whitening models (port of ``rag_cobweb_tpu/whitening/models.py``):
PCA+ICA, PCA+ZCA and full-rank ZCA, and the ``encode_and_whiten_*``
helpers.

The fits are host numpy in float64, copied from the JAX package, so both
packages fit the same model.  Each model is an affine map of the raw rows,
``x @ M + b``; ``affine`` precomposes it (for PCA+ICA center -> project ->
scale -> unmix, for PCA+ZCA center -> project -> scale -> project back,
for ZCA center -> ``W^T``) in float64.  ``transform_torch`` is the device
transform: that one product accumulated in float64 and rounded once to
float32, so the card and the host give the same rows (a float32 product
rounds in each device's summation order, and the tree's near-tie
decisions see a last-bit difference).  ``transform`` is the JAX package's
host numpy transform.  ``save``/``load`` use the JAX package's pickle
layout (a dict of numpy arrays, the model's ``FIELDS``), so either package
loads the other's file.
"""

from __future__ import annotations

import pickle
from typing import Callable, Optional

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


def _maybe_single(x):
    x = np.asarray(x)
    single = x.ndim == 1
    return (x[None, :] if single else x), single


class _AffineWhitener:
    """What the three models share: the device transform of their affine
    map, the pickle ``save``/``load`` of their ``FIELDS`` and the
    constructor from such a dict."""

    FIELDS: tuple = ()

    def _linear(self) -> np.ndarray:
        """The (d_in, d_out) matrix ``M`` in float64."""
        raise NotImplementedError

    def affine(self, dtype=np.float32):
        """The precomposed transform ``(M (d_in, d_out), b)`` in ``dtype``
        (computed in float64), ``b = -mean @ M``."""
        M = self._linear()
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
    def from_dict(cls, d: dict):
        """The model from the dict its ``save`` pickles (``eps`` defaults
        to 1e-8, as in the JAX package's classes)."""
        return cls(**{f: d[f] for f in cls.FIELDS if f != "eps"},
                   eps=d.get("eps", 1e-8))

    def save(self, filepath: str):
        with open(filepath, "wb") as f:
            pickle.dump({k: getattr(self, k) for k in self.FIELDS}, f)

    @classmethod
    def load(cls, filepath: str):
        with open(filepath, "rb") as f:
            return cls.from_dict(pickle.load(f))


class PCAICAWhiteningModel(_AffineWhitener):
    """PCA -> normalize by sqrt(eigenvalue) -> ICA rotation."""

    FIELDS = ("mean", "pca_components", "pca_explained_var", "ica_unmixing",
              "eps")

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
        x, single = _maybe_single(x)
        x_pca = (x - self.mean) @ self.pca_components.T
        x_pca = x_pca / np.sqrt(self.pca_explained_var + self.eps)
        out = x_pca @ self.ica_unmixing.T if is_ica else x_pca
        out = out.astype(np.float32)
        return out[0] if single else out

    def _linear(self):
        scale = 1.0 / np.sqrt(self.pca_explained_var + self.eps)
        return (self.pca_components.T * scale[None, :]) @ self.ica_unmixing.T

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


class PCAZCAWhiteningModel(_AffineWhitener):
    """PCA-whiten, then rotate back to the original basis: d_in columns of
    rank k (the tree spends its full width on them, as in the JAX
    package)."""

    FIELDS = ("mean", "pca_components", "pca_explained_var", "eps")

    def __init__(self, mean, pca_components, pca_explained_var,
                 eps: float = 1e-8):
        self.mean = np.asarray(mean)
        self.pca_components = np.asarray(pca_components)
        self.pca_explained_var = np.asarray(pca_explained_var)
        self.eps = eps
        self._torch_cache: dict = {}

    @property
    def dim_out(self) -> int:
        return self.pca_components.shape[1]

    def _linear(self):
        scale = 1.0 / np.sqrt(self.pca_explained_var + self.eps)
        return (self.pca_components.T * scale[None, :]) @ self.pca_components

    def transform(self, x) -> np.ndarray:
        x, single = _maybe_single(x)
        out = ((x - self.mean) @ self._linear()).astype(np.float32)
        return out[0] if single else out

    @classmethod
    def fit(cls, X, pca_dim=256, eps: float = 1e-8):
        mean, components, explained_var = _pca_fit(X, pca_dim)
        return cls(mean, components, explained_var, eps)


class ZCAWhiteningModel(_AffineWhitener):
    """Full-rank ZCA: W = E diag(1 / sqrt(lambda + eps)) E^T of the
    covariance (independent of the eigenvectors' signs)."""

    FIELDS = ("mean", "whitening_matrix", "eps")

    def __init__(self, mean, whitening_matrix, eps: float = 1e-8):
        self.mean = np.asarray(mean)
        self.whitening_matrix = np.asarray(whitening_matrix)
        self.eps = eps
        self._torch_cache: dict = {}

    @property
    def dim_out(self) -> int:
        return self.whitening_matrix.shape[0]

    def _linear(self):
        return self.whitening_matrix.T

    def transform(self, x) -> np.ndarray:
        x, single = _maybe_single(x)
        out = ((x - self.mean) @ self.whitening_matrix.T).astype(np.float32)
        return out[0] if single else out

    @classmethod
    def fit(cls, X, eps: float = 1e-8):
        X = np.asarray(X, np.float64)
        mean = X.mean(axis=0)
        cov = np.cov(X - mean, rowvar=False)
        eigvals, eigvecs = np.linalg.eigh(cov)
        W = (eigvecs * (1.0 / np.sqrt(eigvals + eps))[None, :]) @ eigvecs.T
        return cls(mean, W, eps)


def _encode(sentences, encode_func: Optional[Callable]):
    """Texts through ``encode_func``, or embeddings as they are."""
    if isinstance(sentences[0], str):
        if encode_func is None:
            raise ValueError("text input needs an encode_func")
        return np.asarray(encode_func(sentences))
    return np.asarray(sentences)


def encode_and_whiten_pcaica(sentences, encode_func, whitening_model,
                             is_ica: bool = True) -> np.ndarray:
    """Encode (or pass embeddings through), then whiten on the host."""
    return whitening_model.transform(_encode(sentences, encode_func),
                                     is_ica=is_ica)


def encode_and_whiten_pcazca(sentences, encode_func,
                             whitening_model) -> np.ndarray:
    return whitening_model.transform(_encode(sentences, encode_func))


def encode_and_whiten_zca(sentences, encode_func,
                          whitening_model) -> np.ndarray:
    """The JAX package's fixed helper: the encoder and the model are
    arguments (the reference's read undefined module globals)."""
    return whitening_model.transform(_encode(sentences, encode_func))
