"""The collectives of the multi-device port, and the candidate merge that
the JAX package writes out four times (``parallel/forest.py:373-380``,
``tp.py:169-175``, ``tp.py:270-276``, ``mesh_vforest.py:217-223``).

``jax.lax.all_gather`` becomes ``all_gather`` (``all_gather_into_tensor``)
and ``jax.lax.psum`` becomes ``all_reduce_sum`` (``all_reduce`` SUM), each
over a mesh axis's process group.  ``merge_topk`` all-gathers every
rank's (B, kk) candidates to (K, B, kk), lays them out (B, K * kk) and
takes the top-k with ``jax.lax.top_k``'s tie order (the lower position
first).

Several ranks on one card run gloo (NCCL refuses them); gloo takes CUDA
tensors in both collectives, and where a build's gloo refuses one the
collective raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from rag_cobweb_tpu_torch.core.index import topk_stable


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` of every rank of ``group``, stacked -> (K, *t.shape)."""
    t = t.contiguous()
    K = dist.get_world_size(group)
    out = torch.empty((K * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out.view((K,) + tuple(t.shape))


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in place; returns it."""
    dist.all_reduce(t, group=group)
    return t


def pad_columns(scores: torch.Tensor, ids: torch.Tensor, width: int):
    """(B, c) candidates padded to ``width`` columns with (-inf, -1), the
    padding the JAX package's common per-shard shapes carry."""
    extra = width - scores.shape[1]
    if extra <= 0:
        return scores, ids
    B = scores.shape[0]
    return (torch.cat([scores, scores.new_full((B, extra), float("-inf"))],
                      1),
            torch.cat([ids, ids.new_full((B, extra), -1)], 1))


def merge_topk(scores: torch.Tensor, ids: torch.Tensor, k: int, group):
    """Every rank's (B, kk) candidates (scores, global ids; kk equal on
    every rank) merged -> the top min(k, K * kk) (scores, ids), lower
    position (rank, then column) first among equal scores.  Each rank
    sends only its own stable top-min(k, kk): no candidate beyond it can
    reach the merged top-k, and the stable cut keeps the column order of
    equal scores, so the result is the full merge's."""
    K = dist.get_world_size(group)
    kk = scores.shape[1]
    top, pos = topk_stable(scores, min(k, kk))
    sent_ids = ids.gather(1, pos).to(torch.int64)
    all_s = all_gather(top.float(), group)              # (K, B, k')
    all_i = all_gather(sent_ids, group)
    B, c = top.shape
    merged = all_s.permute(1, 0, 2).reshape(B, K * c)
    mids = all_i.permute(1, 0, 2).reshape(B, K * c)
    fin, p = topk_stable(merged, min(k, K * kk))
    return fin, mids.gather(1, p)
