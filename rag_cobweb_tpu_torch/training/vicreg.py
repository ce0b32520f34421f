"""VICReg embedding whitening/projection trainer (port of
``rag_cobweb_tpu/training/vicreg.py``).

A projector (Linear-ReLU-Linear-ReLU-Linear, hidden 1024) trained with
the VICReg objective (Bardes, Ponce & LeCun 2022)

    L = sim * invariance(z, z') + std * variance(z) + cov * covariance(z)

on pairs of views (two noisy copies, or paraphrase pairs); the learned
member of the whitening family.  Adam (``optax.adam``: eps 1e-8, no
weight decay).  The variance is the population variance, as ``jnp.var``;
the covariance divides by n - 1.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rag_cobweb_tpu_torch.device import full_f32_matmul, resolve_device
from rag_cobweb_tpu_torch.files import read_pickle
from rag_cobweb_tpu_torch.training.flax_layout import (dense, load_flax,
                                                       to_flax)


class Projector(nn.Module):
    """flax ``Projector``: two ReLU layers of ``hidden``, then ``out_dim``."""

    def __init__(self, in_dim: int, out_dim: int, hidden: int = 1024,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.Dense_0 = dense(in_dim, hidden, gen)
        self.Dense_1 = dense(hidden, hidden, gen)
        self.Dense_2 = dense(hidden, out_dim, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.Dense_1(F.relu(self.Dense_0(x))))
        return self.Dense_2(h)


def vicreg_loss(za: torch.Tensor, zb: torch.Tensor, sim_coeff=25.0,
                std_coeff=25.0, cov_coeff=1.0, gamma=1.0, eps=1e-4):
    """The three VICReg terms of a pair of projected views (B, D) ->
    (loss, {"invariance", "variance", "covariance"})."""
    inv = torch.mean(torch.square(za - zb))

    def var_term(z):
        std = torch.sqrt(torch.var(z, dim=0, correction=0) + eps)
        return torch.mean(F.relu(gamma - std))

    def cov_term(z):
        zc = z - z.mean(dim=0)
        n, d = z.shape
        cov = (zc.T @ zc) / (n - 1)
        off = cov - torch.diag(torch.diag(cov))
        return torch.sum(torch.square(off)) / d

    var = 0.5 * (var_term(za) + var_term(zb))
    cov = 0.5 * (cov_term(za) + cov_term(zb))
    return (sim_coeff * inv + std_coeff * var + cov_coeff * cov,
            {"invariance": inv, "variance": var, "covariance": cov})


def drop_last_order(rng: np.random.Generator, n_items: int,
                    batch_size: int) -> np.ndarray:
    """One epoch's order, as the JAX whitening trainers draw it: a
    permutation cut to whole batches (the last partial one dropped).  Fewer
    rows than a batch raises ``ValueError`` (the JAX package runs no step
    and fails on an unbound name)."""
    n = (n_items // batch_size) * batch_size
    if n == 0:
        raise ValueError(f"{n_items} rows make no batch of {batch_size}")
    return rng.permutation(n_items)[:n]


class VICRegWhitener:
    """Trainable whitening projector with the static whitening models'
    ``transform`` and ``save``/``load``; trains on ``device`` (the card
    unless ``"cpu"``)."""

    def __init__(self, in_dim: int, out_dim: int = 128, hidden: int = 1024,
                 lr: float = 1e-3, sim_coeff: float = 25.0,
                 std_coeff: float = 25.0, cov_coeff: float = 1.0,
                 seed: int = 0, device="cuda"):
        full_f32_matmul()
        self.device = resolve_device(device)
        self.in_dim, self.out_dim, self.hidden = in_dim, out_dim, hidden
        self.coeffs = (sim_coeff, std_coeff, cov_coeff)
        self.net = Projector(in_dim, out_dim, hidden,
                             torch.Generator().manual_seed(seed)
                             ).to(self.device)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=lr, eps=1e-8)
        self.step = 0

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def train_step(self, xa, xb) -> dict:
        """One Adam step on a pair of (B, in_dim) views; returns the loss
        and its three terms (device scalars, before the step)."""
        sim, std, cov = self.coeffs
        loss, metrics = vicreg_loss(self.net(self._tensor(xa)),
                                    self.net(self._tensor(xb)), sim, std,
                                    cov)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.step += 1
        return {k: v.detach() for k, v in dict(metrics, loss=loss).items()}

    def fit(self, views_a, views_b=None, epochs: int = 10,
            batch_size: int = 256, noise: float = 0.1, seed: int = 0,
            log_every: int = 0) -> list:
        """Train on paired views; without ``views_b`` the second view is a
        noisy copy (drawn before the epochs' permutations, as in the JAX
        package).  Returns the last step's metrics of each epoch."""
        views_a = np.asarray(views_a, np.float32)
        rng = np.random.default_rng(seed)
        if views_b is None:
            views_b = views_a + noise * views_a.std(0) * rng.normal(
                size=views_a.shape).astype(np.float32)
        views_b = np.asarray(views_b, np.float32)
        history = []
        for epoch in range(1, epochs + 1):
            order = drop_last_order(rng, len(views_a), batch_size)
            for s in range(0, len(order), batch_size):
                sel = order[s:s + batch_size]
                m = self.train_step(views_a[sel], views_b[sel])
            history.append({k: float(v) for k, v in m.items()})
            if log_every:
                print(f"[vicreg epoch {epoch}] " + " ".join(
                    f"{k}={v:.4f}" for k, v in history[-1].items()))
        return history

    def transform(self, x) -> np.ndarray:
        x = np.asarray(x, np.float32)
        with torch.no_grad():
            out = self.net(self._tensor(np.atleast_2d(x))).cpu().numpy()
        return out[0] if x.ndim == 1 else out

    def save(self, path: str):
        """The JAX package's pickle (dims, coefficients, flax tree)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({"in_dim": self.in_dim, "out_dim": self.out_dim,
                         "hidden": self.hidden, "coeffs": self.coeffs,
                         "params": to_flax(self.net)}, f)

    @classmethod
    def load(cls, path: str, lr: float = 1e-3, device="cuda"):
        """A whitener from a pickle of either package."""
        d = read_pickle(path)
        sim, std, cov = d["coeffs"]
        obj = cls(d["in_dim"], d["out_dim"], d["hidden"], lr=lr,
                  sim_coeff=sim, std_coeff=std, cov_coeff=cov, device=device)
        load_flax(obj.net, d["params"])
        return obj
