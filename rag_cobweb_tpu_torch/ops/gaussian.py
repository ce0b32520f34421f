"""Gaussian sufficient statistics and concept scores (port of
``rag_cobweb_tpu/ops/gaussian.py``).

Plain functions over diagonal-Gaussian concept statistics
``(count, mean, m2)``, where ``m2`` is the Welford sum of squared
deviations.  Every function broadcasts over leading axes, so one
definition serves a single node, a fanout block ``(F, D)`` and a batch of
lanes ``(L, F, D)``.  The arithmetic follows the JAX functions operation
for operation, so elementwise results agree to float32 rounding.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rag_cobweb_tpu_torch.core.config import TreeConfig

_LOG_2PI = math.log(2.0 * math.pi)


class GaussStats(NamedTuple):
    """count (...,), mean (..., D), m2 (..., D)."""

    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor


def _col(count: torch.Tensor) -> torch.Tensor:
    """Broadcast a count against the trailing feature axis."""
    return count.unsqueeze(-1) if count.dim() else count


def welford_insert(stats: GaussStats, x: torch.Tensor) -> GaussStats:
    """Incorporate one instance into running stats (Welford)."""
    count = stats.count + 1.0
    delta = x - stats.mean
    mean = stats.mean + delta / _col(count)
    m2 = stats.m2 + delta * (x - mean)
    return GaussStats(count, mean, m2)


def chan_merge(a: GaussStats, b: GaussStats) -> GaussStats:
    """Merge two sets of stats (Chan et al.): merged m2 from the pre-merge
    means, then the merged mean."""
    total = a.count + b.count
    delta = b.mean - a.mean
    safe_total = torch.where(total > 0, total, torch.ones_like(total))
    ac, bc, st = _col(a.count), _col(b.count), _col(safe_total)
    m2 = a.m2 + b.m2 + delta * delta * ((ac * bc) / st)
    mean = (ac * a.mean + bc * b.mean) / st
    return GaussStats(total, mean, m2)


def compute_var(m2: torch.Tensor, count: torch.Tensor,
                cfg: TreeConfig) -> torch.Tensor:
    """Variance policy: ``m2/count + prior_var``, or the ML variance
    clamped at ``prior_var`` under ``acuity_cutoff``; empty concepts take
    the prior.  ``count`` broadcasts against ``m2``."""
    safe_count = torch.where(count > 0, count, torch.ones_like(count))
    ml_var = m2 / safe_count
    if cfg.acuity_cutoff:
        var = torch.clamp(ml_var, min=cfg.prior_var)
    else:
        var = ml_var + cfg.prior_var
    return torch.where(count > 0, var, torch.full_like(var, cfg.prior_var))


def stats_mean_var(stats: GaussStats, cfg: TreeConfig):
    return stats.mean, compute_var(stats.m2, _col(stats.count), cfg)


def insert_mean_var(stats: GaussStats, x: torch.Tensor, cfg: TreeConfig):
    """(mean, var) after hypothetically absorbing ``x``."""
    s = welford_insert(stats, x)
    return s.mean, compute_var(s.m2, _col(s.count), cfg)


def merge_mean_var(a: GaussStats, b: GaussStats, x: torch.Tensor,
                   cfg: TreeConfig):
    """(mean, var) of merge(a, b) after absorbing ``x``."""
    s = welford_insert(chan_merge(a, b), x)
    return s.mean, compute_var(s.m2, _col(s.count), cfg)


def new_mean_var(x: torch.Tensor, cfg: TreeConfig):
    """(mean, var) of a new concept seeded by ``x``."""
    return x, torch.full_like(x, cfg.prior_var)


def log_prob(x: torch.Tensor, mean: torch.Tensor,
             var: torch.Tensor) -> torch.Tensor:
    """Diagonal-Gaussian log-density over the trailing axis."""
    return -0.5 * torch.sum(
        torch.log(var) + _LOG_2PI + torch.square(x - mean) / var, dim=-1)


def node_log_prob_terms(mean: torch.Tensor, var: torch.Tensor):
    """Per-node affine terms that make the batched log-prob two products:
    -0.5 (sum log var + sum (x - mu)^2 / var) = x @ (mu/var)^T - 0.5 x^2 @
    (1/var)^T - 0.5 (sum mu^2/var + sum log var), the prediction index's
    score without the 2 pi constant.  (N, D) mean and var -> (inv_var_T
    (D, N), mu_over_var_T (D, N), const (N,))."""
    inv_var = 1.0 / var
    mu_over_var = mean * inv_var
    const = -0.5 * (torch.sum(torch.square(mean) * inv_var, dim=-1)
                    + torch.sum(torch.log(var), dim=-1))
    return inv_var.T, mu_over_var.T, const


def batched_node_log_probs(x: torch.Tensor, inv_var_T: torch.Tensor,
                           mu_over_var_T: torch.Tensor,
                           const: torch.Tensor) -> torch.Tensor:
    """(B, D) queries against N node Gaussians -> (B, N) log-probs (the
    prediction index's, without the 2 pi constant) by two float32
    products: ``x @ (mu/var)^T - 0.5 x^2 @ (1/var)^T + const`` (full f32
    on the card: ``device.full_f32_matmul``, the counterpart of the JAX
    package's ``Precision.HIGHEST``)."""
    return (torch.matmul(x, mu_over_var_T)
            - 0.5 * torch.matmul(torch.square(x), inv_var_T) + const)


def compute_score(mu1, var1, mu2, var2, cfg: TreeConfig) -> torch.Tensor:
    """Concept-divergence score: KL(N1 || N2) (use_info & use_kl), the
    entropy delta (use_info only), or the classic continuous category
    utility difference (no use_info)."""
    if cfg.use_info:
        if cfg.use_kl:
            d = mu1.shape[-1]
            score = torch.sum(torch.log(var2) - torch.log(var1), dim=-1)
            score = score + torch.sum(
                (var1 + torch.square(mu1 - mu2)) / var2, dim=-1)
            return (score - d) * 0.5
        return 0.5 * torch.sum(torch.log(var2) - torch.log(var1), dim=-1)
    inv_sqrt_pi_half = 1.0 / (2.0 * math.sqrt(math.pi))
    return (torch.sum(inv_sqrt_pi_half / torch.sqrt(var2), dim=-1)
            - torch.sum(inv_sqrt_pi_half / torch.sqrt(var1), dim=-1))
