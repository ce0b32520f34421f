"""Blocked-index sweep with a per-block candidate pool (kernels 3 and 4).

Port of ``rag_cobweb_tpu/ops/pallas_query.py::_kernel`` (behind
``pallas_blocked_topk``) and ``_kernel_v2`` (behind
``pallas_blocked_topk_tiled``), whose body is ``_kernel``: for every
sentence block and query,

    nlp    = q . movt^T - 0.5 q^2 . ivt^T + const     (B, M) f32
    scores = nlp.astype(W dtype) @ W                  (B, TS) f32

invalid slots ``NEG = -3e38``, then ``kk`` rounds of max/argmax with the
taken slot set to NEG (ties to the lower slot; once every slot is NEG a
round returns NEG at slot 0, as JAX's argmax does).  One CUDA kernel,
``csrc/blocked_topk.cu``, serves both TPU kernels; ``block_candidates_plain``
is the same function in plain PyTorch.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.

``blocked_topk`` keeps the JAX entries' contract and counts the kernel's
launches; ``blocked_topk_tiled`` is the same call with the tiled entry's
default of 16 candidates per block.  The (NB, B, kk) candidates merge with
an exact ``torch.topk`` and slots map through ``sid_of_slot``; the TPU's
tiled entry merged with ``approx_max_k``, which PyTorch lacks.  The JAX
package sized its query chunks to VMEM (``pallas_vmem_estimate``,
``_v2_tile``), padded a ragged batch to its query tile and refused a batch
that did not fit; the kernel masks a ragged query tile itself and streams
M (and, for a wide index, D) through shared memory, so every batch and
width fits as it is.

When TS is above 512 the bf16 kernel splits each block's slots over the
CUDA blocks of a cluster and merges their sorted lists exactly, inside
the kernel.  Its TMA loads need rows of a multiple of 16 bytes, so D must
be a multiple of 8: ``build_blocked_index`` zero-pads it, and the queries
are padded to the index's width here (zero columns add nothing).  The f32
entry (register-tiled products on the CUDA cores at full f32, as the JAX
kernel's ``Precision.HIGHEST``) loads its tiles by TMA too, whose rows
must start 16-byte aligned: where D % 4 != 0 or a row operand is
unaligned, this wrapper hands it zero-padded, aligned copies
(``_f32_rows``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rag_cobweb_tpu_torch.ops import _build

NEG = -3e38


def _check(q, q2, bidx, kk: int):
    NB, M, D = bidx.ivt_b.shape
    TS = bidx.W.shape[2]
    dt = bidx.ivt_b.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"index dtype must be bf16 or f32, got {dt}")
    for name, t, shape in (("queries", q, (q.shape[0], D)),
                           ("q2", q2, (q.shape[0], D)),
                           ("movt_b", bidx.movt_b, (NB, M, D)),
                           ("W", bidx.W, (NB, M, TS))):
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name} must be {shape} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if bidx.const_b.shape != (NB, M) or bidx.const_b.dtype != torch.float32:
        raise ValueError(f"const_b must be ({NB}, {M}) float32")
    if bidx.valid.shape != (NB, TS) or bidx.valid.dtype != torch.bool:
        raise ValueError(f"valid must be ({NB}, {TS}) bool")
    if not 1 <= kk <= TS:
        raise ValueError(f"per-block candidates must be in [1, {TS}], "
                         f"got {kk}")
    devs = {t.device for t in (q, q2, bidx.ivt_b, bidx.movt_b, bidx.const_b,
                               bidx.W, bidx.valid)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def block_scores_plain(q, q2, ivt_b, movt_b, const_b, W, valid):
    """(NB, B, TS) f32 scores of every block, invalid slots NEG, and the
    f32 nlp (NB, B, M) before its rounding to the W dtype."""
    nlp = (torch.einsum("bd,smd->sbm", q.float(), movt_b.float())
           - 0.5 * torch.einsum("bd,smd->sbm", q2.float(), ivt_b.float())
           + const_b.unsqueeze(1))
    s = torch.matmul(nlp.to(W.dtype).float(), W.float())
    return torch.where(valid.unsqueeze(1), s, torch.full_like(s, NEG)), nlp


def block_candidates_plain(q, q2, ivt_b, movt_b, const_b, W, valid,
                           kk: int):
    """Plain version: (NB, B, kk) f32 scores and int32 slots."""
    s, _ = block_scores_plain(q, q2, ivt_b, movt_b, const_b, W, valid)
    top, slot = [], []
    for i in range(kk):
        a = torch.argmax(s, dim=2, keepdim=True)
        top.append(s.gather(2, a))
        slot.append(a)
        if i + 1 < kk:
            s = s.scatter(2, a, NEG)
    return (torch.cat(top, dim=2),
            torch.cat(slot, dim=2).to(torch.int32))


def _f32_rows(ts, D: int):
    """The f32 kernel's TMA loads take rows of 16-byte multiples on
    16-byte boundaries: where D % 4 != 0 or a row operand is not 16-byte
    aligned, q, q2, ivt and movt become zero-padded copies of width D
    rounded up to 4 (zero columns leave both sums unchanged) and W an
    aligned copy.  No served index needs it (``build_blocked_index`` pads
    D to a multiple of 8)."""
    D4 = -(-D // 4) * 4
    out = []
    for name, t in ts:
        if name in ("queries", "q2", "ivt_b", "movt_b") and (
                D4 != D or t.data_ptr() % 16):
            t = F.pad(t, (0, D4 - D)) if D4 != D else t.clone()
        elif name == "W" and t.data_ptr() % 16:
            t = t.clone()
        out.append((name, t))
    return tuple(out), D4


def _block_candidates(q, q2, bidx, kk: int):
    """(NB, B, kk) candidates of every block, by the kernel on the card
    (counted on ``blocked_topk.launches``) or the plain version on the
    host."""
    _check(q, q2, bidx, kk)
    if q.device.type == "cpu":
        return block_candidates_plain(q, q2, bidx.ivt_b, bidx.movt_b,
                                      bidx.const_b, bidx.W, bidx.valid, kk)
    NB, M, D = bidx.ivt_b.shape
    TS = bidx.W.shape[2]
    if M % 16 or TS % 16 or TS > 1024 or NB > 65535:
        raise ValueError(f"the kernel takes M and TS multiples of 16, "
                         f"TS <= 1024 and NB <= 65535; got M={M} TS={TS} "
                         f"NB={NB}")
    if bidx.W.dtype == torch.bfloat16 and D % 8:
        raise ValueError(f"the bf16 kernel loads rows of 16-byte multiples: "
                         f"D must be a multiple of 8 (build_blocked_index "
                         f"pads it), got D={D}")
    ts = (("queries", q), ("q2", q2), ("ivt_b", bidx.ivt_b),
          ("movt_b", bidx.movt_b), ("const_b", bidx.const_b), ("W", bidx.W),
          ("valid", bidx.valid))
    for name, t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if bidx.W.dtype == torch.bfloat16 and t.data_ptr() % 32:
            raise ValueError(f"{name} must be 32-byte aligned")
    if bidx.W.dtype == torch.float32:
        ts, D = _f32_rows(ts, D)
    B = q.shape[0]
    out_s = torch.empty((NB, B, kk), dtype=torch.float32, device=q.device)
    out_t = torch.empty((NB, B, kk), dtype=torch.int32, device=q.device)
    lib = _build.library("blocked_topk")
    fn = (lib.blocked_topk_bf16 if bidx.W.dtype == torch.bfloat16
          else lib.blocked_topk_f32)
    _build.check(_build.launch(q, lambda stream: fn(
        *(t.data_ptr() for _, t in ts), out_s.data_ptr(), out_t.data_ptr(),
        B, NB, M, D, TS, kk, stream)), "blocked_topk launch")
    blocked_topk.launches += 1
    blocked_topk.launches_f32 += bidx.W.dtype == torch.float32
    return out_s, out_t


def _queries(bidx, queries):
    """Zero-padded to the index's width, squared in f32, then ONE cast to
    the index dtype (as the JAX entries do)."""
    dt = bidx.ivt_b.dtype
    D = bidx.ivt_b.shape[2]
    if queries.shape[1] < D:
        queries = F.pad(queries, (0, D - queries.shape[1]))
    q2 = torch.square(queries.float()).to(dt).contiguous()
    return queries.to(dt).contiguous(), q2


def _merge(out_s, out_t, bidx, k: int):
    """(NB, B, kk) candidates -> exact top-k (scores, sentence ids)."""
    NB, B, kk = out_s.shape
    cand_s = out_s.permute(1, 0, 2).reshape(B, NB * kk)
    cand_t = out_t.permute(1, 0, 2).reshape(B, NB * kk)
    top, pos = torch.topk(cand_s, min(k, NB * kk), dim=1)
    slot = cand_t.gather(1, pos).long()
    return top, bidx.sid_of_slot[pos // kk, slot]


def blocked_topk(bidx, queries, k: int, block_k: int = 0):
    """(B, D) queries -> (scores (B, k) f32, sentence ids (B, k) int32),
    the contract of ``pallas_blocked_topk``.  ``block_k``: candidates per
    block (0 = k); the merged pool holds NB * block_k of them."""
    kk = min(block_k or k, bidx.W.shape[2])
    q, q2 = _queries(bidx, queries)
    out_s, out_t = _block_candidates(q, q2, bidx, kk)
    return _merge(out_s, out_t, bidx, k)


blocked_topk.launches = 0       # every launch of the kernel
blocked_topk.launches_f32 = 0   # those of its f32 entry


def blocked_topk_tiled(bidx, queries, k: int, block_k: int = 16):
    """The contract of ``pallas_blocked_topk_tiled``, whose kernel body is
    ``pallas_blocked_topk``'s: ``blocked_topk`` with 16 candidates per
    block by default.  Its launches count on ``blocked_topk.launches``."""
    return blocked_topk(bidx, queries, k, block_k)
