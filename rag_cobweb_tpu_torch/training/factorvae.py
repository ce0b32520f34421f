"""FactorVAE disentanglement trainer (port of
``rag_cobweb_tpu/training/factorvae.py``).

MLP encoder (hidden 1024 -> 512, heads mu and logvar, z_dim 392), a
mirrored decoder, a total-correlation discriminator (256-256-1), the
dimension-wise batch permutation, and the adversarial objective
``recon_mse + kl + gamma * tc`` with gamma 10 and Adam (lr 1e-4, eps
1e-8, as ``optax.adam``) for the VAE and the discriminator apart.

``train_step`` takes its randomness as arguments (the reparameterisation
noise and the two per-dimension permutations), so the same step can run
from the JAX package's draws; ``fit`` draws them from an explicit
``torch.Generator`` on the trainer's device.
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
from rag_cobweb_tpu_torch.training.vicreg import drop_last_order


def _gen(gen: Optional[torch.Generator]) -> torch.Generator:
    return gen if gen is not None else torch.Generator().manual_seed(0)


class MLPEncoder(nn.Module):
    """x -> (mu, logvar): ``hidden``, ``hidden // 2``, then two heads."""

    def __init__(self, input_dim: int, z_dim: int = 392, hidden: int = 1024,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = _gen(gen)
        self.Dense_0 = dense(input_dim, hidden, gen)
        self.Dense_1 = dense(hidden, hidden // 2, gen)
        self.Dense_2 = dense(hidden // 2, z_dim, gen)     # mu
        self.Dense_3 = dense(hidden // 2, z_dim, gen)     # logvar

    def forward(self, x: torch.Tensor):
        h = F.relu(self.Dense_1(F.relu(self.Dense_0(x))))
        return self.Dense_2(h), self.Dense_3(h)


class MLPDecoder(nn.Module):
    """z -> x: ``hidden // 2``, ``hidden``, then ``output_dim``."""

    def __init__(self, z_dim: int, output_dim: int, hidden: int = 1024,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = _gen(gen)
        self.Dense_0 = dense(z_dim, hidden // 2, gen)
        self.Dense_1 = dense(hidden // 2, hidden, gen)
        self.Dense_2 = dense(hidden, output_dim, gen)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.Dense_2(F.relu(self.Dense_1(F.relu(self.Dense_0(z)))))


class Discriminator(nn.Module):
    """z -> one logit: two ReLU layers of ``hidden``."""

    def __init__(self, z_dim: int, hidden: int = 256,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = _gen(gen)
        self.Dense_0 = dense(z_dim, hidden, gen)
        self.Dense_1 = dense(hidden, hidden, gen)
        self.Dense_2 = dense(hidden, 1, gen)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.Dense_1(F.relu(self.Dense_0(z))))
        return self.Dense_2(h)[..., 0]


def random_perms(n_dims: int, batch: int, gen: torch.Generator,
                 device) -> torch.Tensor:
    """(D, B) independent permutations of the batch, one a dimension: the
    argsort of uniform noise, as the JAX package draws them."""
    noise = torch.rand((n_dims, batch), generator=gen, device=device)
    return torch.argsort(noise, dim=1)


def permute_dims(z: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Each latent dimension of (B, D) ``z`` permuted across the batch by
    its row of ``perm`` (D, B)."""
    return torch.gather(z.T, 1, perm).T


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    return mu + torch.exp(0.5 * logvar) * eps


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    return -0.5 * torch.sum(1 + logvar - torch.square(mu) - torch.exp(logvar),
                            dim=1)


class FactorVAE:
    """The three modules, their two Adam optimizers and the fused step, on
    ``device`` (the card unless ``"cpu"``)."""

    def __init__(self, input_dim: int, z_dim: int = 392, gamma: float = 10.0,
                 lr: float = 1e-4, hidden: int = 1024, seed: int = 42,
                 device="cuda"):
        full_f32_matmul()
        self.device = resolve_device(device)
        self.input_dim, self.z_dim, self.gamma = input_dim, z_dim, gamma
        self.hidden = hidden
        gen = torch.Generator().manual_seed(seed)
        self.encoder = MLPEncoder(input_dim, z_dim, hidden, gen).to(
            self.device)
        self.decoder = MLPDecoder(z_dim, input_dim, hidden, gen).to(
            self.device)
        self.disc = Discriminator(z_dim, gen=gen).to(self.device)
        self._vae_params = (list(self.encoder.parameters())
                            + list(self.decoder.parameters()))
        self.opt_vae = torch.optim.Adam(self._vae_params, lr=lr, eps=1e-8)
        self.opt_disc = torch.optim.Adam(self.disc.parameters(), lr=lr,
                                         eps=1e-8)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0

    def draws(self, batch: int):
        """One step's randomness from the trainer's generator: (eps (B,
        z_dim), perm1 (z_dim, B), perm2 (z_dim, B))."""
        eps = torch.randn((batch, self.z_dim), generator=self._gen,
                          device=self.device)
        return (eps, random_perms(self.z_dim, batch, self._gen, self.device),
                random_perms(self.z_dim, batch, self._gen, self.device))

    def _encode_decode(self, batch, eps):
        mu, logvar = self.encoder(batch)
        z = reparameterize(mu, logvar, eps)
        return mu, logvar, z, self.decoder(z)

    def train_step(self, batch, eps, perm1, perm2) -> dict:
        """One FactorVAE step: the discriminator's BCE step on (z, z
        permuted by ``perm1``) with z detached, then the VAE's step with the
        updated discriminator (``perm2``), its gradient flowing through the
        discriminator into z but reaching only the encoder and decoder.
        Both halves use the same ``eps``.  Returns the metrics (device
        scalars): recon_mse, kl, tc, disc, vae."""
        x = torch.as_tensor(batch, dtype=torch.float32, device=self.device)
        eps, perm1, perm2 = (torch.as_tensor(a, device=self.device)
                             for a in (eps, perm1, perm2))
        with torch.no_grad():
            z_det = self._encode_decode(x, eps)[2]
        z_perm = permute_dims(z_det, perm1.long())
        real, fake = self.disc(z_det), self.disc(z_perm)
        disc_loss = 0.5 * (
            F.binary_cross_entropy_with_logits(real, torch.ones_like(real))
            + F.binary_cross_entropy_with_logits(fake,
                                                 torch.zeros_like(fake)))
        self.opt_disc.zero_grad(set_to_none=True)
        disc_loss.backward()
        self.opt_disc.step()

        mu, logvar, z, recon = self._encode_decode(x, eps)
        recon_loss = torch.mean(torch.square(recon - x))
        kl = kl_divergence(mu, logvar).mean()
        tc = (self.disc(z) - self.disc(permute_dims(z, perm2.long()))).mean()
        vae_loss = recon_loss + kl + self.gamma * tc
        self.opt_vae.zero_grad(set_to_none=True)
        vae_loss.backward(inputs=self._vae_params)
        self.opt_vae.step()
        self.step += 1
        return {k: v.detach() for k, v in (
            ("recon_mse", recon_loss), ("kl", kl), ("tc", tc),
            ("disc", disc_loss), ("vae", vae_loss))}

    def encode(self, x, sample: bool = False,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mu (B, z_dim) on the device, or a sample with noise ``eps`` (a
        draw from a generator seeded 0 when None)."""
        with torch.no_grad():
            mu, logvar = self.encoder(torch.as_tensor(
                np.asarray(x, np.float32), device=self.device))
            if not sample:
                return mu
            if eps is None:
                g = torch.Generator(device=self.device).manual_seed(0)
                eps = torch.randn(mu.shape, generator=g, device=self.device)
            return reparameterize(mu, logvar, eps)

    def fit(self, embeddings, epochs: int = 20, batch_size: int = 256,
            log_every: int = 0, save_dir: Optional[str] = None,
            seed: int = 42, diag_samples: int = 4096) -> list:
        """The training loop (the last partial batch dropped, as in the JAX
        package) with per-epoch correlation diagnostics and the last step's
        metrics; returns the history."""
        embeddings = np.asarray(embeddings, np.float32)
        rng = np.random.default_rng(seed)
        history = []
        for epoch in range(1, epochs + 1):
            order = drop_last_order(rng, len(embeddings), batch_size)
            for s in range(0, len(order), batch_size):
                sel = order[s:s + batch_size]
                metrics = self.train_step(embeddings[sel],
                                          *self.draws(len(sel)))
            z = self.encode(embeddings[:diag_samples]).cpu().numpy()
            diag = latent_correlation_diagnostics(z)
            diag["epoch"] = epoch
            diag.update({k: float(v) for k, v in metrics.items()})
            history.append(diag)
            if log_every:
                print(f"[epoch {epoch}] mean_abs_offdiag_corr="
                      f"{diag['mean_abs_offdiag']:.6f} "
                      f"recon={diag['recon_mse']:.5f}")
            if save_dir:
                self.save(os.path.join(save_dir,
                                       f"factorvae_epoch{epoch}.pkl"))
        return history

    def save(self, path: str):
        """The JAX package's pickle: dims, gamma, hidden and the
        (encoder, decoder, discriminator) flax trees."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({"input_dim": self.input_dim, "z_dim": self.z_dim,
                         "gamma": self.gamma, "hidden": self.hidden,
                         "params": (to_flax(self.encoder),
                                    to_flax(self.decoder),
                                    to_flax(self.disc))}, f)

    @classmethod
    def load(cls, path: str, lr: float = 1e-4, device="cuda"):
        """A FactorVAE from a pickle of either package."""
        blob = read_pickle(path)
        obj = cls(blob["input_dim"], z_dim=blob["z_dim"],
                  gamma=blob["gamma"], hidden=blob.get("hidden", 1024),
                  lr=lr, device=device)
        for module, tree in zip((obj.encoder, obj.decoder, obj.disc),
                                blob["params"]):
            load_flax(module, tree)
        return obj


def latent_correlation_diagnostics(z: np.ndarray, top_k: int = 10) -> dict:
    """Mean |off-diagonal| latent correlation and the most correlated
    pairs (host numpy, as in the JAX package)."""
    z = np.asarray(z)
    c = np.corrcoef(z, rowvar=False)
    c = np.nan_to_num(c)
    d = c.shape[0]
    off = np.abs(c - np.diag(np.diag(c)))
    iu = np.triu_indices(d, k=1)
    vals = off[iu]
    order = np.argsort(vals)[::-1][:top_k]
    pairs = [(int(iu[0][i]), int(iu[1][i]), float(c[iu[0][i], iu[1][i]]))
             for i in order]
    return {
        "mean_abs_offdiag": float(vals.mean()) if len(vals) else 0.0,
        "top_pairs": pairs,
    }
