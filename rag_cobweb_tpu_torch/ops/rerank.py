"""Exact re-rank distances (kernel 5).

Port of the row-gather + squared-L2 Pallas kernel of
``scripts/gather_probe.py`` (the kernel behind
``rag_cobweb_tpu/core/index.py::exact_rerank``): for every candidate
``cand[b, j]`` the fresh-leaf log-probability
``-0.5 * (||q_b - emb[cand[b, j]]||^2 / prior_var + D * log(prior_var))``
in the diff form, -inf where ``cand_scores[b, j]`` is not finite.  The
store ``emb`` holds f32 rows, or bf16 rows (the compressed re-rank store:
each row widened to f32 before the diff, the query f32).  The CUDA kernel
is ``csrc/rerank_l2.cu`` (entries ``rerank_l2`` and ``rerank_l2_bf16``,
one template on the row type); ``rerank_lp_plain`` is the same function in
plain PyTorch.  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from rag_cobweb_tpu_torch.ops import _build
from rag_cobweb_tpu_torch.utils import profiling

_ENTRY = {torch.float32: "rerank_l2", torch.bfloat16: "rerank_l2_bf16"}


def _check(emb, queries, cand, cand_scores):
    if emb.dim() != 2 or emb.dtype not in _ENTRY:
        raise ValueError("emb must be (S, D) float32 or bfloat16")
    B, C = cand.shape
    if queries.shape != (B, emb.shape[1]) or queries.dtype != torch.float32:
        raise ValueError(f"queries must be ({B}, {emb.shape[1]}) float32")
    if cand.dtype != torch.int32:
        raise TypeError(f"cand must be int32, got {cand.dtype}")
    if cand_scores.shape != (B, C) or cand_scores.dtype != torch.float32:
        raise ValueError(f"cand_scores must be ({B}, {C}) float32")
    devs = {t.device for t in (emb, queries, cand, cand_scores)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _pv_terms(prior_var, D: int, device):
    pv = torch.tensor(prior_var, dtype=torch.float32, device=device)
    return pv, D * torch.log(pv)


def rerank_lp_plain(emb, queries, cand, cand_scores, prior_var):
    pv, d_log_pv = _pv_terms(prior_var, queries.shape[1], emb.device)
    x = emb[cand.long()].float()                            # (B, C, D)
    d2 = torch.sum(torch.square(queries.unsqueeze(1) - x), dim=-1)
    lp = -0.5 * (d2 / pv + d_log_pv)
    return torch.where(torch.isfinite(cand_scores), lp,
                       torch.full_like(lp, float("-inf")))


def rerank_lp(emb, queries, cand, cand_scores, prior_var):
    """(B, C) f32 re-rank keys of the candidates."""
    _check(emb, queries, cand, cand_scores)
    if emb.device.type == "cpu":
        return rerank_lp_plain(emb, queries, cand, cand_scores, prior_var)
    for name, t in (("emb", emb), ("queries", queries), ("cand", cand),
                    ("cand_scores", cand_scores)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, C = cand.shape
    D = emb.shape[1]
    pv, d_log_pv = _pv_terms(prior_var, D, "cpu")   # host: no device sync
    out = torch.empty((B, C), dtype=torch.float32, device=emb.device)
    entry = _ENTRY[emb.dtype]
    fn = getattr(_build.library("rerank_l2"), entry)
    _build.check(_build.launch(emb, lambda stream: fn(
        emb.data_ptr(), queries.data_ptr(), cand.data_ptr(),
        cand_scores.data_ptr(), out.data_ptr(), B, C, D, float(pv.item()),
        float(d_log_pv.item()), stream)), f"{entry} launch")
    profiling.count("launch.rerank_lp")
    if emb.dtype == torch.bfloat16:
        profiling.count("launch.rerank_lp_bf16")
    return out
