"""Pools of the fused path-score sweep ``[q, q^2] @ GT + c``.

``slab_topk`` (kernel 1) ports ``rag_cobweb_tpu/ops/pallas_query.py::
_fused_kernel``: for every 2048-row slab of ``GT`` and every query, the
top-``kappa`` (invalid rows -inf) as (score, global row id), ties to the
lower id, in no particular order within a slab (the plain version happens
to return them sorted).

``slab_group_topk`` ports ``_fused_group_kernel``: the same sweep, invalid
rows NEG = -3e38, and for every 128-row group ``per_group`` rounds of
max/argmax (ties to the lower row, the taken row set to NEG); column
``i * 16 + g`` holds round i of group g.  ``fused_group_topk`` is the
entry of ``pallas_fused_group_topk`` over a serving ``FusedIndex``.

Both kernels live in ``csrc/fused_topk.cu``, each with a bf16 entry (on
wgmma) and an f32 entry (CUDA cores, full f32; the two f32 entries share
one sweep); a wrapper's ``launches`` counts every launch and
``launches_f32`` those of the f32 entry.  Every entry loads its query
boxes by TMA, so ``_launch`` hands it qq in zero-padded 16-byte rows
where 2D or its alignment needs it.  Each ``*_plain`` function is the
same function in plain PyTorch.  A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from rag_cobweb_tpu_torch.ops import _build

SLAB = 2048  # slab width = core/index._FUSED_ROW_BUCKET
GROUP = 128  # rows per group of the group pool
NG = SLAB // GROUP
NEG = -3e38  # the TPU kernels' mask value


def _check(qq, GT, c, valid, kappa, limit: int = SLAB):
    if qq.dim() != 2 or GT.dim() != 2 or qq.shape[1] != GT.shape[0]:
        raise ValueError(f"qq {tuple(qq.shape)} and GT {tuple(GT.shape)} "
                         "do not contract")
    if qq.dtype != GT.dtype or GT.dtype not in (torch.bfloat16,
                                                torch.float32):
        raise TypeError(f"qq/GT must share bf16 or f32, got {qq.dtype}, "
                        f"{GT.dtype}")
    Sp = GT.shape[1]
    if Sp % SLAB:
        raise ValueError(f"GT columns {Sp} are not a multiple of {SLAB}")
    if c.shape != (Sp,) or c.dtype != torch.float32:
        raise ValueError("c must be (Sp,) float32")
    if valid.shape != (Sp,) or valid.dtype != torch.bool:
        raise ValueError("valid must be (Sp,) bool")
    if not 1 <= kappa <= limit:
        raise ValueError(f"kappa must be in [1, {limit}], got {kappa}")
    devs = {t.device for t in (qq, GT, c, valid)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def query_terms(queries, dtype):
    """``qq = [q, q^2]`` (squares in f32) cast to the GT dtype."""
    q = queries.float()
    return torch.cat([q, torch.square(q)], dim=1).to(dtype).contiguous()


def slab_scores_plain(qq, GT, c, valid, fill: float):
    """(B, NS, SLAB) scores ``qq @ GT + c`` with f32 operands and f32
    accumulation; invalid rows ``fill``."""
    s = torch.matmul(qq.float(), GT.float()) + c
    s = torch.where(valid, s, torch.full_like(s, fill))
    return s.view(qq.shape[0], GT.shape[1] // SLAB, SLAB)


def merge(out_s, out_i, k: int):
    """(NS, B, K) pools -> the exact top-k (scores, ids) of each query."""
    NS, B, K = out_s.shape
    cand_s = out_s.permute(1, 0, 2).reshape(B, NS * K)
    cand_i = out_i.permute(1, 0, 2).reshape(B, NS * K)
    top, pos = torch.topk(cand_s, min(k, NS * K), dim=1)
    return top, cand_i.gather(1, pos)


def slab_topk_plain(qq, GT, c, valid, kappa: int):
    """Plain version: scores viewed per slab, stable descending sort,
    first kappa."""
    s = slab_scores_plain(qq, GT, c, valid, float("-inf"))
    NS = s.shape[1]
    top, pos = torch.sort(s, dim=2, descending=True, stable=True)
    base = torch.arange(NS, device=s.device).view(1, NS, 1) * SLAB
    ids = (pos[:, :, :kappa] + base).to(torch.int32)
    return (top[:, :, :kappa].permute(1, 0, 2).contiguous(),
            ids.permute(1, 0, 2).contiguous())


def _launch(fn_name: str, qq, GT, c, valid, sel: int, width: int):
    """Launch ``fn_name`` of the fused_topk library; (NS, B, width) out."""
    for name, t in (("qq", qq), ("GT", GT), ("c", c), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if GT.data_ptr() % 32:
        raise ValueError("GT must be 32-byte aligned (tensor-core loads)")
    B, twoD = qq.shape
    Sp = GT.shape[1]
    row = 16 // qq.element_size()
    if twoD % row or qq.data_ptr() % 16:
        # the query boxes come by TMA: 16-byte rows, the pad zero
        qp = qq.new_zeros((B, twoD + -twoD % row))
        qp[:, :twoD] = qq
        qq = qp
    out_s = torch.empty((Sp // SLAB, B, width), dtype=torch.float32,
                        device=qq.device)
    out_i = torch.empty((Sp // SLAB, B, width), dtype=torch.int32,
                        device=qq.device)
    lib = _build.library("fused_topk")
    suffix = "bf16" if GT.dtype == torch.bfloat16 else "f32"
    fn = getattr(lib, f"{fn_name}_{suffix}")
    _build.check(_build.launch(qq, lambda stream: fn(
        qq.data_ptr(), GT.data_ptr(), c.data_ptr(), valid.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), B, twoD, Sp, sel, stream)),
        f"{fn_name} launch")
    return out_s, out_i


def slab_topk(qq, GT, c, valid, kappa: int):
    """(NS, B, kappa) f32 scores and int32 global row ids."""
    _check(qq, GT, c, valid, kappa)
    if qq.device.type == "cpu":
        return slab_topk_plain(qq, GT, c, valid, kappa)
    out = _launch("fused_topk", qq, GT, c, valid, kappa, kappa)
    slab_topk.launches += 1
    slab_topk.launches_f32 += GT.dtype == torch.float32
    return out


slab_topk.launches = 0       # every launch of the kernel
slab_topk.launches_f32 = 0   # those of its f32 entry


def slab_group_topk_plain(qq, GT, c, valid, per_group: int):
    """Plain version of the group pool: scores with invalid rows NEG,
    then ``per_group`` rounds of argmax (first index of the max) and
    masking per 128-row group."""
    s = slab_scores_plain(qq, GT, c, valid, NEG)
    B, NS = s.shape[:2]
    s = s.view(B, NS, NG, GROUP)
    goff = (torch.arange(NS, device=s.device).view(NS, 1) * SLAB
            + torch.arange(NG, device=s.device).view(1, NG) * GROUP)
    top, ids = [], []
    for i in range(per_group):
        a = torch.argmax(s, dim=3, keepdim=True)
        top.append(s.gather(3, a).squeeze(3))
        ids.append(a.squeeze(3) + goff)
        if i + 1 < per_group:
            s = s.scatter(3, a, NEG)
    out_s = torch.cat(top, dim=2).permute(1, 0, 2).contiguous()
    out_i = torch.cat(ids, dim=2).to(torch.int32).permute(1, 0, 2)
    return out_s, out_i.contiguous()


def slab_group_topk(qq, GT, c, valid, per_group: int):
    """(NS, B, per_group * 16) f32 scores and int32 global row ids."""
    _check(qq, GT, c, valid, per_group, limit=GROUP)
    if qq.device.type == "cpu":
        return slab_group_topk_plain(qq, GT, c, valid, per_group)
    out = _launch("fused_group_topk", qq, GT, c, valid, per_group,
                  per_group * NG)
    slab_group_topk.launches += 1
    slab_group_topk.launches_f32 += GT.dtype == torch.float32
    return out


slab_group_topk.launches = 0       # every launch of the kernel
slab_group_topk.launches_f32 = 0   # those of its f32 entry


def fused_group_topk(fidx, queries, k: int, per_group: int = 2):
    """Group-max pool over a ``FusedIndex``: (B, D) -> (scores (B, k) f32,
    row ids (B, k) int32), drawn from the top ``per_group`` of every 128
    adjacent rows.  ``qq = [q, q^2]`` is cast to the GT dtype as in
    ``pallas_fused_group_topk``; its merge is ``approx_max_k`` on the TPU
    and an exact ``torch.topk`` here."""
    qq = query_terms(queries, fidx.GT.dtype)
    return merge(*slab_group_topk(qq, fidx.GT, fidx.c, fidx.valid,
                                  per_group), k)
