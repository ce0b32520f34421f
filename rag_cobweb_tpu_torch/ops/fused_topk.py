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

``pool_sweep`` and ``pool_select`` are kernel 1's entry for a query's
exact top-``k`` pool, in two halves that the index runs under its sweep
and merge spans.  They dispatch on shapes (``use_pruned``) between the
per-slab pools merged by ``torch.topk`` (``merge(*slab_topk(...))``) and
the pruned path (``pruned_sweep``): a group-max pass bounds each query's
``k``-th score, a second sweep keeps only the rows at or above the bound,
and a sort of those survivors gives the top ``k``, ties to the lower id,
so that no per-slab pool is written where ``NS kappa`` is far above
``k``.  A query with more survivors than its buffer (``prune_cap``) is
answered by its per-slab pools instead (``pool.overflow`` counts such
queries).

The kernels live in ``csrc/fused_topk.cu``, each with a bf16 entry (on
wgmma) and, but the pruned path, an f32 entry (CUDA cores, full f32; the
two f32 entries share one sweep); each launch counts on
``launch.<wrapper>`` in ``utils/profiling``'s registry, and one of the
f32 entry also on ``launch.<wrapper>_f32``; a pruned pool counts on
``launch.slab_topk`` and ``launch.slab_topk_pruned``.  Every entry loads
its query boxes by TMA, so ``_prepared`` hands it qq in zero-padded
16-byte rows where 2D or its alignment needs it.  Each ``*_plain``
function is the same function in plain PyTorch.  A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rag_cobweb_tpu_torch.ops import _build
from rag_cobweb_tpu_torch.utils import profiling

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


def _prepared(qq, GT, c, valid):
    """The launch's inputs checked, qq padded to 16-byte rows."""
    for name, t in (("qq", qq), ("GT", GT), ("c", c), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if GT.data_ptr() % 32:
        raise ValueError("GT must be 32-byte aligned (tensor-core loads)")
    B, twoD = qq.shape
    row = 16 // qq.element_size()
    if twoD % row or qq.data_ptr() % 16:
        # the query boxes come by TMA: 16-byte rows, the pad zero
        qp = qq.new_zeros((B, twoD + -twoD % row))
        qp[:, :twoD] = qq
        qq = qp
    return qq


def _launch(fn_name: str, qq, GT, c, valid, sel: int, width: int):
    """Launch ``fn_name`` of the fused_topk library; (NS, B, width) out."""
    B, twoD = qq.shape
    Sp = GT.shape[1]
    qq = _prepared(qq, GT, c, valid)
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
    _count("launch.slab_topk", GT)
    return out


def _count(name: str, GT):
    profiling.count(name)
    if GT.dtype == torch.float32:
        profiling.count(name + "_f32")


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
    _count("launch.slab_group_topk", GT)
    return out


def fused_group_topk(fidx, queries, k: int, per_group: int = 2):
    """Group-max pool over a ``FusedIndex``: (B, D) -> (scores (B, k) f32,
    row ids (B, k) int32), drawn from the top ``per_group`` of every 128
    adjacent rows.  ``qq = [q, q^2]`` is cast to the GT dtype as in
    ``pallas_fused_group_topk``; its merge is ``approx_max_k`` on the TPU
    and an exact ``torch.topk`` here."""
    qq = query_terms(queries, fidx.GT.dtype)
    return merge(*slab_group_topk(qq, fidx.GT, fidx.c, fidx.valid,
                                  per_group), k)


# -- kernel 1 at scale: the pruned pool ------------------------------------

PRUNE_GROUP = 64    # pass A keeps each 64-row group's maximum
PRUNE_MAX_2D = 320  # the passes hold a block's GT (2D <= 5 chunks of 64)

# The pruned path's second sweep reads GT once more (bytes bound at small
# B), where the per-slab select and merge grow with B min(k, 2048), and it
# costs the host ~0.2 ms more a call (its launches and the overflow read);
# on an H100 it gains more than that from B min(k, 2048) = PRUNE_B 2D
# (PERF.md, kernel 1's crossovers: at 2D = 667, B = 32 the two tie on the
# device, and the pruned path lost the mixed cell's p95 on the host).
PRUNE_B = 64

# The per-slab pools of the overflowed queries are taken this many bytes
# of pools and their merge's keys at a time.
FALLBACK_BYTES = 1 << 30


def prune_cap(k: int) -> int:
    """The survivors a query the pruned path keeps for a pool of ``k``: four
    times ``k``, rounded up to a power of two."""
    return 1 << (4 * k - 1).bit_length()


def _groups(NS: int) -> int:
    """Pass A's keys a query."""
    return NS * (SLAB // PRUNE_GROUP)


def use_pruned(B: int, NS: int, k: int, two_d: int, elt: int) -> bool:
    """Whether ``pool_sweep`` takes the pruned path, from the shapes alone:
    bf16 operands of 2D <= 320; per-slab pools (NS slabs of min(k, 2048))
    at least 16 times the pool; enough groups (8 k) that their k-th key
    bounds the pool tightly; and a batch past the crossover with the second
    sweep."""
    kk = min(k, NS * SLAB)
    kappa = min(k, SLAB)
    return (elt == 2 and two_d <= PRUNE_MAX_2D and NS * kappa >= 16 * kk
            and _groups(NS) >= 8 * kk and B * kappa >= PRUNE_B * two_d)


def pool_bytes(B: int, NS: int, k: int, two_d: int, elt: int) -> int:
    """Device bytes a query of the pool that ``pool_sweep`` takes at batch
    ``B`` holds: pass A's keys and the survivors' buffer, or the per-slab
    pools."""
    kk = min(k, NS * SLAB)
    if use_pruned(B, NS, k, two_d, elt):
        return _groups(NS) * 4 + prune_cap(kk) * 8 + kk * 8
    return NS * min(k, SLAB) * 8


def score_keys(s):
    """The kernels' order-preserving 32-bit key of each f32 score (-0 as
    +0), as int64 in [0, 2^32)."""
    s = torch.where(s == 0, torch.zeros_like(s), s)
    b = s.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= 1 << 31, 0xFFFFFFFF - b, b + (1 << 31))


def select_keys(scores, ids, k: int):
    """(B, n) (score, id) candidates -> their top ``k`` by (score desc,
    id asc), sorted, as the final selection orders them."""
    keys = (score_keys(scores) - (1 << 31)) * (1 << 32) + (
        0xFFFFFFFF - ids.to(torch.int64))
    _, pos = torch.topk(keys, min(k, keys.shape[1]), dim=1)
    return scores.gather(1, pos), ids.gather(1, pos)


class Pruned(NamedTuple):
    """A pruned pool of ``k`` between its sweep and its selection: the
    survivors' buffer size ``cap``; the plain version's (B, k) pool, or
    None; the kernels' survivor buffer (B, cap) of 64-bit keys, or None;
    the survivor counts (B,), pass A's keys and the overflow count."""
    k: int
    cap: int
    pool: tuple
    buffer: torch.Tensor
    survivors: torch.Tensor
    groups: torch.Tensor
    over: torch.Tensor


def pruned_sweep_plain(qq, GT, c, valid, k: int, cap: int) -> Pruned:
    """Plain version of passes A and B and the bound: the scores once
    (both passes share them), each 64-row group's maximum (a group is the
    kernel's: columns 8j + 2q + e of a 128-row block over a pair of its
    lanes q), the k-th group key per query (0 with fewer keys than k), the
    valid rows of finite score at or above it, and their top k as the
    final selection would take it."""
    s = slab_scores_plain(qq, GT, c, valid, float("-inf"))
    B, NS = s.shape[:2]
    kk = min(k, NS * SLAB)
    gs = s.view(B, NS * NG, 16, 2, 4).permute(0, 1, 3, 2, 4).reshape(
        B, -1, PRUNE_GROUP)
    gk = score_keys(gs.amax(dim=2))
    if gk.shape[1] < kk:
        bound = torch.zeros((B,), dtype=torch.int64, device=s.device)
    else:
        bound = torch.topk(gk, kk, dim=1).values[:, -1]
    s = s.reshape(B, -1)
    keep = valid & (s > float("-inf")) & (score_keys(s) >= bound.view(B, 1))
    count = keep.sum(dim=1).to(torch.int32)
    ids = torch.arange(s.shape[1], device=s.device, dtype=torch.int32)
    top, idx = select_keys(torch.where(keep, s, torch.full_like(s, NEG)),
                           ids.expand(B, -1), kk)
    dead = top == NEG
    pool = (top.masked_fill(dead, float("-inf")), idx.masked_fill(dead, -1))
    over = (count > cap).sum().view(1).to(torch.int32)
    return Pruned(kk, cap, pool, None, count, gk, over)


def pruned_sweep(qq, GT, c, valid, k: int, cap: int = None) -> Pruned:
    """Passes A and B and the bound of the pruned pool of ``k`` (bf16
    operands, 2D <= 320 on the card), ``cap`` survivors a query kept
    (``prune_cap(k)`` by default)."""
    Sp = GT.shape[-1]
    _check(qq, GT, c, valid, min(k, Sp), limit=Sp)
    kk = min(k, Sp)
    cap = cap or prune_cap(kk)
    if cap < kk:
        raise ValueError(f"a buffer of {cap} for a pool of {kk}")
    if qq.device.type == "cpu":
        return pruned_sweep_plain(qq, GT, c, valid, kk, cap)
    if GT.dtype != torch.bfloat16:
        raise TypeError("the pruned path takes bf16 operands")
    B, twoD = qq.shape
    if twoD > PRUNE_MAX_2D:
        raise ValueError(f"the pruned path takes 2D <= {PRUNE_MAX_2D}, "
                         f"got {twoD}")
    qq = _prepared(qq, GT, c, valid)
    dev = qq.device
    gv = torch.empty((B, _groups(Sp // SLAB)), dtype=torch.int32,
                     device=dev)
    bound = torch.empty((B,), dtype=torch.int32, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    over = torch.empty((1,), dtype=torch.int32, device=dev)
    surv = torch.empty((B, cap), dtype=torch.int64, device=dev)
    cm = torch.where(valid, c, torch.full_like(c, float("-inf")))
    lib = _build.library("fused_topk")
    _build.check(_build.launch(qq, lambda stream: lib.fused_prune_bf16(
        qq.data_ptr(), GT.data_ptr(), cm.data_ptr(), gv.data_ptr(),
        bound.data_ptr(), count.data_ptr(), surv.data_ptr(), over.data_ptr(),
        B, twoD, Sp, kk, cap, stream)), "fused_prune launch")
    _count("launch.slab_topk", GT)
    profiling.count("launch.slab_topk_pruned")
    return Pruned(kk, cap, None, surv, count, gv, over)


def pruned_select(p: Pruned):
    """The final selection of a pruned pool -> (scores (B, k), ids (B, k)),
    and the number of queries with more survivors than ``p.cap``."""
    if p.buffer is None:
        return p.pool, p.over
    surv = p.buffer
    B, kk = surv.shape[0], p.k
    out_s = torch.empty((B, kk), dtype=torch.float32, device=surv.device)
    out_i = torch.empty((B, kk), dtype=torch.int32, device=surv.device)
    lib = _build.library("fused_topk")
    _build.check(_build.launch(surv, lambda stream: lib.fused_prune_final(
        surv.data_ptr(), p.survivors.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), p.over.data_ptr(), B, p.cap, kk, stream)),
        "fused_prune_final launch")
    return (out_s, out_i), p.over


class Pending(NamedTuple):
    """``pool_sweep``'s result, for ``pool_select``: the inputs, the pool
    size and either the per-slab pools or the pruned path's passes."""
    args: tuple
    k: int
    pools: tuple
    pruned: Pruned


def pool_sweep(qq, GT, c, valid, k: int, pruned: bool = None,
               cap: int = None) -> Pending:
    """Kernel 1's sweep for the exact top-``k`` pool of ``qq @ GT + c``
    (invalid rows -inf): the per-slab pools (``slab_topk``), or the pruned
    path's passes (``pruned_sweep``), as ``use_pruned`` rules on the
    shapes; ``pruned`` overrides the rule and ``cap`` the survivors' buffer
    (tests, probes).  ``pool_select`` then takes the pool."""
    if pruned is None:
        NS = GT.shape[1] // SLAB if GT.dim() == 2 else 0
        pruned = use_pruned(qq.shape[0], NS, k, qq.shape[1],
                            GT.element_size())
    args = (qq, GT, c, valid)
    if not pruned:
        return Pending(args, k, slab_topk(*args, min(k, SLAB)), None)
    return Pending(args, k, None, pruned_sweep(*args, k, cap))


def pool_select(pend: Pending):
    """The exact pool of ``pool_sweep`` -> (scores (B, k'), ids (B, k')),
    k' = min(k, Sp), sorted: the per-slab pools merged by ``torch.topk``,
    or the pruned path's survivors sorted, ties to the lower id.  A pruned
    pool costs one read of its overflow count to the host; the queries
    whose survivors overflowed the buffer (counted on ``pool.overflow``)
    are answered by their per-slab pools, with the same tie rule, a chunk
    of them at a time (``FALLBACK_BYTES``)."""
    if pend.pruned is None:
        return merge(*pend.pools, pend.k)
    p = pend.pruned
    (out_s, out_i), over = pruned_select(p)
    n = int(over.item())
    if n == 0:
        return out_s, out_i
    profiling.count("pool.overflow", n)
    qq, GT, c, valid = pend.args
    kappa = min(pend.k, SLAB)
    cand = GT.shape[1] // SLAB * kappa
    # 48 bytes a candidate: its pool entry, the permuted copies, and the
    # merge's int64 keys and their temporaries
    step = max(1, FALLBACK_BYTES // (cand * 48))
    for rows in torch.nonzero(p.survivors > p.cap).view(-1).split(step):
        ps, pi = slab_topk(qq.index_select(0, rows), GT, c, valid, kappa)
        m = len(rows)
        out_s[rows], out_i[rows] = select_keys(
            ps.permute(1, 0, 2).reshape(m, cand),
            pi.permute(1, 0, 2).reshape(m, cand), p.k)
    return out_s, out_i
