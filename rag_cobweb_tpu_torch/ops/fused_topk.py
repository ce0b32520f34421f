"""Per-slab top-kappa of the fused path-score sweep (kernel 1).

Port of ``rag_cobweb_tpu/ops/pallas_query.py::_fused_kernel``: for every
2048-row slab of ``GT`` and every query, the top-``kappa`` of
``[q, q^2] @ GT + c`` (invalid rows -inf) as (score, global row id), ties
to the lower id, in no particular order within a slab (the plain version
happens to return them sorted).  The CUDA kernel is ``csrc/fused_topk.cu``;
``slab_topk_plain`` is the same function in plain PyTorch.  A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from rag_cobweb_tpu_torch.ops import _build

SLAB = 2048  # slab width = core/index._FUSED_ROW_BUCKET


def _check(qq, GT, c, valid, kappa):
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
    if not 1 <= kappa <= SLAB:
        raise ValueError(f"kappa must be in [1, {SLAB}], got {kappa}")
    devs = {t.device for t in (qq, GT, c, valid)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def slab_topk_plain(qq, GT, c, valid, kappa: int):
    """Plain version: scores (f32 operands, f32 accumulation) viewed per
    slab, stable descending sort, first kappa."""
    B, Sp = qq.shape[0], GT.shape[1]
    NS = Sp // SLAB
    s = torch.matmul(qq.float(), GT.float()) + c
    s = torch.where(valid, s, torch.full_like(s, float("-inf")))
    top, pos = torch.sort(s.view(B, NS, SLAB), dim=2, descending=True,
                          stable=True)
    base = torch.arange(NS, device=s.device).view(1, NS, 1) * SLAB
    ids = (pos[:, :, :kappa] + base).to(torch.int32)
    return (top[:, :, :kappa].permute(1, 0, 2).contiguous(),
            ids.permute(1, 0, 2).contiguous())


def slab_topk(qq, GT, c, valid, kappa: int):
    """(NS, B, kappa) f32 scores and int32 global row ids."""
    _check(qq, GT, c, valid, kappa)
    if qq.device.type == "cpu":
        return slab_topk_plain(qq, GT, c, valid, kappa)
    for name, t in (("qq", qq), ("GT", GT), ("c", c), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if GT.data_ptr() % 32:
        raise ValueError("GT must be 32-byte aligned (tensor-core loads)")
    B, twoD = qq.shape
    Sp = GT.shape[1]
    out_s = torch.empty((Sp // SLAB, B, kappa), dtype=torch.float32,
                        device=qq.device)
    out_i = torch.empty((Sp // SLAB, B, kappa), dtype=torch.int32,
                        device=qq.device)
    lib = _build.library("fused_topk")
    fn = lib.fused_topk_bf16 if GT.dtype == torch.bfloat16 \
        else lib.fused_topk_f32
    with torch.cuda.device(qq.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(qq.data_ptr(), GT.data_ptr(), c.data_ptr(),
                        valid.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                        B, twoD, Sp, kappa, stream), "fused_topk launch")
    slab_topk.launches += 1
    return out_s, out_i


slab_topk.launches = 0
