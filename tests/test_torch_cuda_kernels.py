"""The port's CUDA kernels on the card, against their plain PyTorch
versions, and the fused and blocked engines on the card against the
host.  Marked
``cuda``: they need an NVIDIA GPU (sm_90a) and nvcc, and skip without
one.  Run them on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda
"""

import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def _launches(name: str) -> int:
    """The registry's count of launches ``launch.<name>``."""
    from rag_cobweb_tpu_torch.utils import profiling
    return profiling.counter("launch." + name)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA kernels have no host mode")
    from rag_cobweb_tpu_torch.device import full_f32_matmul
    full_f32_matmul()
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,twoD,kappa", [(1, 8, 1), (37, 99, 64),
                                          (20, 130, 2048)])
def test_fused_topk_kernel_matches_plain(card, dtype, B, twoD, kappa):
    from rag_cobweb_tpu_torch.ops import fused_topk
    g = torch.Generator(device=card).manual_seed(B + twoD)
    Sp, S = 4096, 3500
    qq = torch.randn((B, twoD), generator=g, device=card).to(dtype)
    GT = (0.1 * torch.randn((twoD, Sp), generator=g, device=card)).to(dtype)
    c = torch.randn((Sp,), generator=g, device=card)
    valid = torch.arange(Sp, device=card) < S
    ks, ki = fused_topk.slab_topk(qq, GT, c, valid, kappa)
    ps, pi = fused_topk.slab_topk_plain(qq, GT, c, valid, kappa)
    torch.cuda.synchronize()
    ks = torch.sort(ks, dim=2, descending=True).values   # pool is unordered
    fin = torch.isfinite(ps)
    assert torch.equal(fin, torch.isfinite(ks))
    torch.testing.assert_close(ks[fin], ps[fin], rtol=1e-3, atol=1e-3)
    assert torch.equal(torch.sort(ki, dim=2).values,
                       torch.sort(pi, dim=2).values)


def _dyadic_sweep(card, dtype, B, twoD, Sp, S, seed):
    """Sweep inputs whose scores are exact in float32 in any order (small
    multiples of powers of two, at most 18 significant bits a score), so
    the kernel and the plain version tie exactly where they tie."""
    g = torch.Generator(device=card).manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=card).float()

    qq = (ints(-8, 9, (B, twoD)) / 8).to(dtype)
    GT = (ints(-16, 17, (twoD, Sp)) / 16).to(dtype)
    c = ints(-64, 65, (Sp,)) / 4
    return qq, GT, c, torch.arange(Sp, device=card) < S


def _same_pool(fused_topk, qq, GT, c, valid, kappa):
    ks, ki = fused_topk.slab_topk(qq, GT, c, valid, kappa)
    ps, pi = fused_topk.slab_topk_plain(qq, GT, c, valid, kappa)
    torch.cuda.synchronize()
    assert ks.shape == ps.shape and ki.dtype == torch.int32
    # each slab's pool is unordered in the kernel, sorted in the plain one
    assert torch.equal(torch.sort(ks, dim=2, descending=True).values, ps)
    assert torch.equal(torch.sort(ki, dim=2).values,
                       torch.sort(pi, dim=2).values)
    # every id carries its score
    full = fused_topk.slab_scores_plain(qq, GT, c, valid, float("-inf"))
    base = (torch.arange(ks.shape[0], device=ks.device) * fused_topk.SLAB)
    at = full.permute(1, 0, 2).gather(2, (ki - base.view(-1, 1, 1)).long())
    assert torch.equal(at, ks)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,twoD,kappa", [
    (1, 8, 1), (63, 99, 16), (65, 496, 1024), (1024, 1536, 2048),
    (65, 1536, 16), (1024, 496, 1024), (63, 8, 2048), (1, 99, 1024)])
def test_fused_topk_kernel_exact_on_dyadic_scores(card, dtype, B, twoD,
                                                  kappa):
    """Scores exact in any order, many of them tied: the same pool as the
    plain version's, ids and all, for B over one and two query tiles, 2D
    ragged, resident (<= 512) and carried through the ring, and kappa
    from 1 to the whole slab."""
    from rag_cobweb_tpu_torch.ops import fused_topk
    _same_pool(fused_topk, *_dyadic_sweep(card, dtype, B, twoD, 4096, 3500,
                                          B + twoD + kappa), kappa)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_topk_ties_straddle_the_cluster_blocks(card, dtype):
    """kappa = 1024 of 2048 where the kappa-th score is shared by rows on
    both sides of a CUDA block boundary (every 256 rows): query b scores
    2 at rows (i + b) % 3 == 0 and 1 elsewhere, so the 341-342 rows of
    score 1 it takes are the lowest ids, across the first two blocks; the
    second slab is all invalid (-inf): its pool is its first 1024 rows."""
    from rag_cobweb_tpu_torch.ops import fused_topk
    twoD, Sp, B = 16, 4096, 40
    i = torch.arange(Sp, device=card)
    GT = torch.stack([torch.where((i + r) % 3 == 0, 2.0, 1.0)
                      for r in range(twoD)]).to(dtype)
    qq = torch.zeros((B, twoD), device=card)
    qq[torch.arange(B), torch.arange(B) % 3] = 1.0
    c = torch.zeros(Sp, device=card)
    valid = i < 2048
    _same_pool(fused_topk, qq.to(dtype), GT, c, valid, 1024)
    ks, ki = fused_topk.slab_topk(qq.to(dtype), GT, c, valid, 1024)
    torch.cuda.synchronize()
    assert bool(torch.isinf(ks[1]).all())
    assert torch.equal(torch.sort(ki[1], dim=1).values,
                       (2048 + torch.arange(1024, device=card,
                                            dtype=torch.int32)).expand(B, -1))


@pytest.mark.parametrize("B", [1, 8, 32, 1000])
def test_fused_topk_f32_kernel_at_the_served_shape(card, B):
    """Kernel 1's f32 entry at the single tree's f32 fused index shape
    (2D=496, Sp=10240, 10000 valid rows) and kappa 10, as ``rerank=0``
    serves it, on dyadic scores: the plain version's pools, ids and all,
    through one launch of the f32 entry."""
    from rag_cobweb_tpu_torch.ops import fused_topk
    args = _dyadic_sweep(card, torch.float32, B, 496, 10240, 10000, B)
    before = _launches("slab_topk_f32")
    _same_pool(fused_topk, *args, 10)
    assert _launches("slab_topk_f32") == before + 1


@pytest.mark.parametrize("kappa", [10, 1024])
def test_fused_topk_f32_ties_straddle_every_block_border(card, kappa):
    """Query b reads the 12 depths of class g = b % 8 (one per row: row i
    scores from depth 12 g + i % 12, so tied scores come from different
    depth chunks) and sees rows of three levels, laid out so that the
    kappa-th score is tied across CTA blocks (256 rows each) and its cut
    falls in every block over the 8 classes: at kappa 10 one level-1 row a
    block (offset 100) and 2 + g level-2 rows at the slab's top ids; at
    kappa 1024 level 1 from row 256 g + 37 on (the cut falls in block g +
    4, or g - 4), level 0 below.  The plain version's pools, ids and all,
    in both slabs (the second with 1500 valid rows)."""
    from rag_cobweb_tpu_torch.ops import fused_topk
    Sp, B, twoD = 4096, 16, 96
    i = torch.arange(Sp, device=card) % 2048
    GT = torch.zeros((twoD, Sp), device=card)
    for g in range(8):
        if kappa == 10:
            lvl = ((i % 256 == 100).float()
                   + 2.0 * (i >= 2048 - (2 + g)).float())
        else:
            lvl = (i >= 256 * g + 37).float()
        GT[12 * g + i % 12, torch.arange(Sp, device=card)] = lvl
    qq = torch.zeros((B, twoD), device=card)
    for b in range(B):
        qq[b, 12 * (b % 8):12 * (b % 8) + 12] = 1.0
    c = torch.zeros(Sp, device=card)
    valid = torch.arange(Sp, device=card) < 2048 + 1500
    _same_pool(fused_topk, qq, GT, c, valid, kappa)


@pytest.mark.parametrize("B,twoD,kappa", [(33, 30, 10), (33, 30, 1024),
                                          (1, 496, 2048)])
def test_fused_topk_f32_unaligned_ragged_queries_and_whole_slab(card, B,
                                                               twoD,
                                                               kappa):
    """qq of 2D = 30 (rows not 16-byte multiples) in a view 4 bytes off a
    16-byte boundary, which the wrapper copies to padded, aligned rows for
    the TMA query boxes, and kappa = 2048 (the whole slab) at B = 1: the
    plain version's pools, ids and all, on dyadic scores."""
    from rag_cobweb_tpu_torch.ops import fused_topk
    qq, GT, c, valid = _dyadic_sweep(card, torch.float32, B, twoD, 4096,
                                     3500, B + twoD + kappa)
    if twoD == 30:
        buf = torch.zeros(qq.numel() + 1, device=card)
        buf[1:] = qq.flatten()
        qq = buf[1:].view(qq.shape)
        assert qq.is_contiguous() and qq.data_ptr() % 16
    _same_pool(fused_topk, qq, GT, c, valid, kappa)


@pytest.mark.parametrize("B,D,S,C", [(1, 768, 3000, 300),
                                     (32, 50, 3000, 300),
                                     (1024, 768, 3000, 300),
                                     (1024, 766, 3000, 300),
                                     (1024, 50, 500, 300),
                                     (32, 768, 1 << 20, 1024)])
def test_rerank_kernel_batches_duplicates_and_empty_rows(card, B, D, S, C):
    """B = 1, 32 and 1024 (B * C / 64 below and above twice the SMs, so
    both block sizes run), D ragged, ids repeated within a query's list,
    one query with every candidate -inf, and 1M rows at B = 32."""
    from rag_cobweb_tpu_torch.ops import rerank
    g = torch.Generator(device=card).manual_seed(B + D + C)
    emb = torch.randn((S, D), generator=g, device=card)
    q = torch.randn((B, D), generator=g, device=card)
    cand = torch.randint(0, S, (B, C), generator=g, device=card,
                         dtype=torch.int32)
    cand[:, 1::3] = cand[:, ::3][:, :cand[:, 1::3].shape[1]]
    cs = torch.randn((B, C), generator=g, device=card)
    cs[:, ::7] = -math.inf
    cs[B // 2] = -math.inf
    pv = 1.0 / (2.0 * math.e * math.pi)
    lk = rerank.rerank_lp(emb, q, cand, cs, pv)
    lp = rerank.rerank_lp_plain(emb, q, cand, cs, pv)
    torch.cuda.synchronize()
    fin = torch.isfinite(lp)
    assert torch.equal(fin, torch.isfinite(lk))
    assert not bool(fin[B // 2].any())
    torch.testing.assert_close(lk[fin], lp[fin], rtol=1e-5, atol=0.0)
    dup = cand[:, 1::3] == cand[:, ::3][:, :cand[:, 1::3].shape[1]]
    both = fin[:, 1::3] & fin[:, ::3][:, :dup.shape[1]]
    assert torch.equal(lk[:, 1::3][dup & both],
                       lk[:, ::3][:, :dup.shape[1]][dup & both])


@pytest.mark.parametrize("D", [768, 50])
def test_rerank_kernel_matches_plain(card, D):
    from rag_cobweb_tpu_torch.ops import rerank
    g = torch.Generator(device=card).manual_seed(D)
    S, B, C = 3000, 33, 300
    emb = torch.randn((S, D), generator=g, device=card)
    q = torch.randn((B, D), generator=g, device=card)
    cand = torch.randint(0, S, (B, C), generator=g, device=card,
                         dtype=torch.int32)
    cs = torch.randn((B, C), generator=g, device=card)
    cs[:, ::5] = -math.inf
    pv = 1.0 / (2.0 * math.e * math.pi)
    lk = rerank.rerank_lp(emb, q, cand, cs, pv)
    lp = rerank.rerank_lp_plain(emb, q, cand, cs, pv)
    torch.cuda.synchronize()
    fin = torch.isfinite(lp)
    assert torch.equal(fin, torch.isfinite(lk))
    torch.testing.assert_close(lk[fin], lp[fin], rtol=1e-5, atol=0.0)


def _holds(ks, ki, ps, full, tol):
    """Kernel candidates against the plain version's, both in round order:
    scores within ``tol``, and each kernel id that is not an exhausted
    (NEG) round carries its score in the plain version's ``full`` scores,
    so ids differ only among ties."""
    assert bool(((ks - ps).abs() <= tol).all()), float((ks - ps).abs().max())
    at = full.gather(2, ki.long())
    real = ks > -1e38
    assert bool(((at - ks).abs() <= tol)[real].all())


def _blocked_index(card, dtype, NB, M, D, TS, S_last, seed, ties=False):
    """Random blocked index with small dyadic terms (nlp exact in f32, so
    the kernel and the plain version round the same nlp to bf16) and
    ~P=6 nonzero path weights per slot; ``ties``: 0/1 weights on the first
    8 nodes only, so many slots share a score exactly.  D is zero-padded to
    a multiple of 8, as ``build_blocked_index`` pads it."""
    from rag_cobweb_tpu_torch.core.index import BlockedIndex, pad_width
    g = torch.Generator(device=card).manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g,
                             device=card).float()

    W = torch.rand((NB, M, TS), generator=g, device=card)
    W = torch.where(torch.rand((NB, M, TS), generator=g, device=card)
                    < 6.0 / M, W, torch.zeros_like(W))
    if ties:
        W = (torch.rand((NB, M, TS), generator=g, device=card)
             < 0.5).float()
        W[:, 8:] = 0.0
    valid = torch.ones((NB, TS), dtype=torch.bool, device=card)
    valid[-1, S_last:] = False
    D8 = -(-D // 8) * 8
    return BlockedIndex(
        ivt_b=pad_width(ints(1, 17, (NB, M, D)) / 16, D8).to(dtype),
        movt_b=pad_width(ints(-8, 9, (NB, M, D)) / 16, D8).to(dtype),
        const_b=ints(-64, 65, (NB, M)) / 4, W=W.to(dtype).contiguous(),
        valid=valid,
        sid_of_slot=torch.arange(NB * TS, device=card,
                                 dtype=torch.int32).view(NB, TS))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,NB,M,D,TS,S_last,kk", [
    (1, 1, 16, 8, 16, 16, 1),          # smallest tiles
    (37, 5, 80, 20, 64, 40, 8),        # ragged B, D and M chunk
    (70, 3, 144, 136, 512, 200, 16),   # D over two 64-column TMA boxes
    (40, 3, 144, 384, 512, 300, 16),   # 2D > 512: query segments carried
    (65, 2, 80, 768, 512, 100, 16),    # the encoder width, unwhitened
    (9, 2, 64, 300, 256, 200, 20),     # a short last segment
    (33, 2, 32, 128, 1024, 700, 4),    # TS > 512: a cluster per block
    (20, 2, 48, 16, 32, 5, 12),        # kk above the valid slots: NEG
    (5, 2, 64, 16, 64, 50, 64),        # kk = TS
    (9, 2, 48, 24, 512, 300, 512),     # kk = TS = 512: the lists of a split
])
def test_blocked_topk_kernel_matches_plain(card, dtype, B, NB, M, D, TS,
                                           S_last, kk):
    from rag_cobweb_tpu_torch.ops import blocked_topk as bt
    bidx = _blocked_index(card, dtype, NB, M, D, TS, S_last, B + M)
    g = torch.Generator(device=card).manual_seed(B)
    q = (torch.randint(-8, 9, (B, D), generator=g, device=card).float()
         / 8).to(dtype)
    qd, q2 = bt._queries(bidx, q)
    ks, ki = bt._block_candidates(qd, q2, bidx, kk)
    ps, pi = bt.block_candidates_plain(qd, q2, bidx.ivt_b, bidx.movt_b,
                                       bidx.const_b, bidx.W, bidx.valid, kk)
    full, _ = bt.block_scores_plain(qd, q2, bidx.ivt_b, bidx.movt_b,
                                    bidx.const_b, bidx.W, bidx.valid)
    torch.cuda.synchronize()
    _holds(ks, ki, ps, full, 1e-3 + 1e-3 * ps.abs())
    neg = ps <= bt.NEG / 2          # exhausted rounds: NEG at slot 0
    assert torch.equal(neg, ks <= bt.NEG / 2)
    assert bool((ki[neg] == 0).all())


@pytest.mark.parametrize("B", [1, 8, 32, 200])
def test_blocked_topk_kernel_at_the_served_shape(card, B):
    """The 100k cell's block shape (M=768, D=128, TS=512, kk=16) on a
    dyadic index of 40 blocks: one CUDA block takes all 512 slots of a
    block and query tile (40 of them at B <= 32, 160 at B=200) and
    filters its rows before sorting them."""
    from rag_cobweb_tpu_torch.ops import blocked_topk as bt
    bidx = _blocked_index(card, torch.bfloat16, 40, 768, 128, 512, 400, B)
    g = torch.Generator(device=card).manual_seed(B)
    q = (torch.randint(-8, 9, (B, 128), generator=g, device=card).float()
         / 8).to(torch.bfloat16)
    qd, q2 = bt._queries(bidx, q)
    ks, ki = bt._block_candidates(qd, q2, bidx, 16)
    ps, pi = bt.block_candidates_plain(qd, q2, bidx.ivt_b, bidx.movt_b,
                                       bidx.const_b, bidx.W, bidx.valid, 16)
    full, _ = bt.block_scores_plain(qd, q2, bidx.ivt_b, bidx.movt_b,
                                    bidx.const_b, bidx.W, bidx.valid)
    torch.cuda.synchronize()
    _holds(ks, ki, ps, full, 1e-3 + 1e-3 * ps.abs())


@pytest.mark.parametrize("ties,S_last", [(True, 512), (False, 5),
                                          (True, 9)])
def test_blocked_topk_kernel_ties_and_exhausted_rows(card, ties, S_last):
    """All 512 slots in one CUDA block (70 blocks x 3 query tiles fill the
    card), with exactly tied scores (the order falls to the lower slot)
    and a last block of few valid slots (its rows give (NEG, 0) after
    them): the same candidates, in the same order, as the plain version."""
    from rag_cobweb_tpu_torch.ops import blocked_topk as bt
    bidx = _blocked_index(card, torch.bfloat16, 70, 64, 16, 512, S_last,
                          S_last, ties=ties)
    g = torch.Generator(device=card).manual_seed(S_last)
    q = (torch.randint(-8, 9, (130, 16), generator=g, device=card).float()
         / 8).to(torch.bfloat16)
    qd, q2 = bt._queries(bidx, q)
    ks, ki = bt._block_candidates(qd, q2, bidx, 16)
    ps, pi = bt.block_candidates_plain(qd, q2, bidx.ivt_b, bidx.movt_b,
                                       bidx.const_b, bidx.W, bidx.valid, 16)
    torch.cuda.synchronize()
    torch.testing.assert_close(ks, ps, rtol=1e-3, atol=1e-3)
    neg = ps <= bt.NEG / 2
    assert torch.equal(neg, ks <= bt.NEG / 2)
    assert bool((ki[neg] == 0).all())
    if ties:            # exact scores: the tie order is the plain one
        assert torch.equal(ki, pi)


@pytest.mark.parametrize("B", [1, 8, 32, 200])
def test_blocked_topk_f32_kernel_at_the_served_shape(card, B):
    """The single tree's f32 blocked index shape (NB=20, M=768, D=248,
    TS=512, kk=10, 272 valid slots in the last block) on an index of
    dyadic terms: 8-, 32- and 64-query tiles, M split over a cluster at
    B <= 32 and not at B=200."""
    from rag_cobweb_tpu_torch.ops import blocked_topk as bt
    bidx = _blocked_index(card, torch.float32, 20, 768, 248, 512, 272, B)
    g = torch.Generator(device=card).manual_seed(B)
    q = torch.randint(-8, 9, (B, 248), generator=g, device=card).float() / 8
    qd, q2 = bt._queries(bidx, q)
    before = _launches("blocked_topk_f32")
    ks, ki = bt._block_candidates(qd, q2, bidx, 10)
    assert _launches("blocked_topk_f32") == before + 1
    ps, pi = bt.block_candidates_plain(qd, q2, bidx.ivt_b, bidx.movt_b,
                                       bidx.const_b, bidx.W, bidx.valid, 10)
    full, _ = bt.block_scores_plain(qd, q2, bidx.ivt_b, bidx.movt_b,
                                    bidx.const_b, bidx.W, bidx.valid)
    torch.cuda.synchronize()
    _holds(ks, ki, ps, full, 1e-3 + 1e-3 * ps.abs())


def _dyadic_f32(card, NB, M, D, TS, S_last, seed):
    """An f32 blocked index whose scores are exact in f32 in any order
    (``bench.kernel_ab``'s), and queries of its width."""
    from rag_cobweb_tpu_torch.bench.kernel_ab import dyadic_f32_index
    bidx = dyadic_f32_index(NB, M, D, TS, S_last, seed)
    g = torch.Generator(device=card).manual_seed(seed)
    return bidx, torch.randint(-8, 9, (130, D), generator=g,
                               device=card).float() / 8


def _same_candidates(bt, q, bidx, kk):
    """The kernel's candidates equal the plain version's, score and slot,
    exhausted rounds (NEG at slot 0) included."""
    qd, q2 = bt._queries(bidx, q)
    ks, ki = bt._block_candidates(qd, q2, bidx, kk)
    ps, pi = bt.block_candidates_plain(qd, q2, bidx.ivt_b, bidx.movt_b,
                                       bidx.const_b, bidx.W, bidx.valid, kk)
    torch.cuda.synchronize()
    assert torch.equal(ks, ps), float((ks - ps).abs().max())
    assert torch.equal(ki, pi), int((ki != pi).sum())
    return ps


@pytest.mark.parametrize("index,S_last", [("ties", 512), ("ties", 9),
                                          ("dyadic", 5), ("dyadic", 300)])
def test_blocked_topk_f32_kernel_ties_and_exhausted_rows(card, index,
                                                         S_last):
    """Exact f32 scores: many exactly tied (0/1 path weights on the first 8
    nodes) or few valid slots in the last block (its rows run into
    exhausted rounds): the kernel gives the plain version's candidates, in
    the same order, on 130 queries (three 64-query tiles) of 70 blocks."""
    from rag_cobweb_tpu_torch.ops import blocked_topk as bt
    if index == "ties":
        bidx = _blocked_index(card, torch.float32, 70, 64, 16, 512, S_last,
                              S_last, ties=True)
        q = (torch.randint(-8, 9, (130, 16), device=card).float() / 8)
    else:
        bidx, q = _dyadic_f32(card, 70, 64, 16, 512, S_last, S_last)
    ps = _same_candidates(bt, q, bidx, 16)
    assert bool((ps <= bt.NEG / 2).any()) == (S_last < 16)


@pytest.mark.parametrize("case", ["unaligned", "D=30"])
def test_blocked_topk_f32_kernel_unaligned_batch_and_ragged_width(card,
                                                                  case):
    """The wrapper hands the f32 kernel's TMA loads 16-byte aligned rows of
    a multiple of 4 floats: a query batch 4 bytes off a 16-byte boundary
    (a view into a flat buffer) is copied, and an index of D=30 (not
    padded by ``build_blocked_index``) is zero-padded with its queries to
    D=32; both give the plain version's candidates exactly (M=112: two
    64-node chunks, the second ragged)."""
    from rag_cobweb_tpu_torch.ops import blocked_topk as bt
    D = 30 if case == "D=30" else 24
    bidx, q = _dyadic_f32(card, 6, 112, D, 64, 50, D)
    q = q[:45]
    if case == "unaligned":
        buf = torch.zeros(q.numel() + 1, device=card)
        buf[1:] = q.flatten()
        q = buf[1:].view(q.shape)
        assert q.is_contiguous() and q.data_ptr() % 16
    _same_candidates(bt, q, bidx, 8)


def test_blocked_entries_agree_on_the_card(card):
    """Both entries on a ragged batch (45 queries, no multiple of the
    kernel's query tile) give the host's plain merged pool, and each call
    is one launch on ``launch.blocked_topk``."""
    from rag_cobweb_tpu_torch.ops import blocked_topk as bt
    bidx = _blocked_index(card, torch.bfloat16, 6, 64, 24, 64, 30, 1)
    q = torch.randint(-8, 9, (45, 24), device=card).float() / 8
    host = type(bidx)(*(t.cpu() for t in bidx))
    for entry in (bt.blocked_topk, bt.blocked_topk_tiled):
        before = _launches("blocked_topk")
        s1, _ = entry(bidx, q, 40, block_k=8)
        assert _launches("blocked_topk") == before + 1
        s2, _ = entry(host, q.cpu(), 40, block_k=8)
        torch.testing.assert_close(s1.cpu(), s2, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,twoD,per_group,S", [(1, 8, 1, 4096),
                                                (37, 99, 2, 3500),
                                                (20, 130, 5, 2050)])
def test_group_topk_kernel_matches_plain(card, dtype, B, twoD, per_group,
                                         S):
    from rag_cobweb_tpu_torch.ops import fused_topk as ft
    g = torch.Generator(device=card).manual_seed(B + twoD)
    Sp = 4096
    qq = torch.randn((B, twoD), generator=g, device=card).to(dtype)
    GT = (0.1 * torch.randn((twoD, Sp), generator=g, device=card)).to(dtype)
    c = torch.randn((Sp,), generator=g, device=card)
    valid = torch.arange(Sp, device=card) < S
    ks, ki = ft.slab_group_topk(qq, GT, c, valid, per_group)
    ps, pi = ft.slab_group_topk_plain(qq, GT, c, valid, per_group)
    full = ft.slab_scores_plain(qq, GT, c, valid, ft.NEG).permute(1, 0, 2)
    torch.cuda.synchronize()
    base = (torch.arange(Sp // ft.SLAB, device=card) * ft.SLAB).view(-1, 1, 1)
    _holds(ks, ki - base, ps, full, 1e-3 + 1e-3 * ps.abs())
    neg = ps <= ft.NEG / 2          # exhausted rounds: the group's first row
    assert torch.equal(neg, ks <= ft.NEG / 2)
    assert torch.equal(ki[neg], pi[neg])


def _group_holds(ft, qq, GT, c, valid, per_group, exact=False):
    """Kernel 2 against its plain version: scores within 1e-3 + 1e-3 |s|
    in round order, each id carrying its score (ids differ only among rows
    tied within that), exhausted rounds (NEG, the group's first row) as
    the plain version's; ``exact`` (dyadic scores): equal scores and ids."""
    ks, ki = ft.slab_group_topk(qq, GT, c, valid, per_group)
    ps, pi = ft.slab_group_topk_plain(qq, GT, c, valid, per_group)
    torch.cuda.synchronize()
    assert ks.shape == ps.shape and ki.dtype == torch.int32
    if exact:
        assert torch.equal(ks, ps) and torch.equal(ki, pi)
        return
    full = ft.slab_scores_plain(qq, GT, c, valid, ft.NEG).permute(1, 0, 2)
    base = (torch.arange(GT.shape[1] // ft.SLAB, device=qq.device)
            * ft.SLAB).view(-1, 1, 1)
    _holds(ks, ki - base, ps, full, 1e-3 + 1e-3 * ps.abs())
    neg = ps <= ft.NEG / 2
    assert torch.equal(neg, ks <= ft.NEG / 2)
    assert torch.equal(ki[neg], pi[neg])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("per_group", [1, 2, 16, 128])
@pytest.mark.parametrize("B", [1, 32, 1000])
@pytest.mark.parametrize("twoD", [496, 256])
def test_group_topk_kernel_at_the_served_widths(card, twoD, B, per_group,
                                                dtype):
    """The served indexes' widths (flagship and single tree 2D=496, 100k
    2D=256), the batches the serving gives a kernel, and per_group from 1
    to the whole group (the last rounds of a group with invalid rows are
    exhausted); both entries (f32: the single tree's exact index)."""
    from rag_cobweb_tpu_torch.ops import fused_topk as ft
    g = torch.Generator(device=card).manual_seed(B + twoD + per_group)
    Sp, S = 6144, 5000
    q = torch.randn((B, twoD // 2), generator=g, device=card)
    qq = torch.cat([q, q * q], 1).to(dtype)
    GT = (0.05 * torch.randn((twoD, Sp), generator=g, device=card)) \
        .to(dtype)
    c = torch.randn((Sp,), generator=g, device=card)
    _group_holds(ft, qq, GT, c, torch.arange(Sp, device=card) < S,
                 per_group)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,twoD,per_group", [(1, 8, 3), (65, 99, 2),
                                              (130, 256, 7), (63, 520, 128)])
def test_group_topk_kernel_ties_across_the_groups_of_a_block(card, B, twoD,
                                                             per_group,
                                                             dtype):
    """Dyadic scores (exact in any order) taking few values, so every group
    holds many rows tied with each other and with the rows of the group
    beside it in the same 256-column block: the same rounds, ids and all,
    as the plain version's; B ragged, 2D odd (qq's rows padded for TMA)
    and above 512, the last slab partly invalid; both entries."""
    from rag_cobweb_tpu_torch.ops import fused_topk as ft
    g = torch.Generator(device=card).manual_seed(B + twoD)
    Sp, S = 4096, 3000
    qq = (torch.randint(0, 2, (B, twoD), generator=g, device=card).float()
          / 2).to(dtype)
    GT = (torch.randint(0, 2, (twoD, Sp), generator=g, device=card).float()
          / 4).to(dtype)
    c = torch.randint(0, 3, (Sp,), generator=g, device=card).float()
    _group_holds(ft, qq, GT, c, torch.arange(Sp, device=card) < S,
                 per_group, exact=True)


@pytest.mark.parametrize("B", [1, 2, 8, 17, 33, 65, 1000])
def test_f32_entries_at_every_query_tile(card, B):
    """The batches that take each query tile of the f32 launcher (1, 8,
    16, 32, 64 queries) on five slabs, 2D odd and above 512 (qq's rows
    padded for TMA), the last slab partly invalid and one group cut below
    per_group: kernel 2's f32 rounds equal the plain version's, ids and
    exhausted rounds too, and kernel 1's f32 pool on the same sweep."""
    from rag_cobweb_tpu_torch.ops import fused_topk as ft
    Sp = 5 * ft.SLAB
    qq, GT, c, valid = _dyadic_sweep(card, torch.float32, B, 523, Sp, 9000,
                                     B)
    valid[3 * ft.GROUP + 2:4 * ft.GROUP] = False
    before = _launches("slab_group_topk_f32")
    _group_holds(ft, qq, GT, c, valid, 5, exact=True)
    assert _launches("slab_group_topk_f32") == before + 1
    _same_pool(ft, qq, GT, c, valid, 10)


@pytest.mark.parametrize("B", [1, 32, 1024])
def test_fused_topk_kernel_at_the_100k_shape(card, B):
    """Kernel 1 at the 100k cell's served fused index shape (2D=256,
    Sp=100352: 49 slabs, kappa=512), on dyadic scores: the same pool, ids
    and all; 49 to 784 items over the clusters that fit the card."""
    from rag_cobweb_tpu_torch.ops import fused_topk
    _same_pool(fused_topk, *_dyadic_sweep(card, torch.bfloat16, B, 256,
                                          100352, 100000, B), 512)


@pytest.mark.parametrize("B,kappa", [(40, 1024), (130, 700)])
def test_fused_topk_persistent_clusters_keep_the_tie_rule(card, B, kappa):
    """More (slab, query tile) items than clusters fit the card (40 and 120
    items), each with the kappa-th score shared by rows on both sides of a
    CUDA block boundary (rows (i + b) % 3 == 0 score 2, the rest 1), so
    every item's select, inbox and offsets start clean: the same pools as
    the plain version's, and the lowest rows of score 1."""
    from rag_cobweb_tpu_torch.ops import fused_topk
    twoD, Sp = 16, 40 * 2048
    i = torch.arange(Sp, device=card)
    GT = torch.stack([torch.where((i + r) % 3 == 0, 2.0, 1.0)
                      for r in range(twoD)]).to(torch.bfloat16)
    qq = torch.zeros((B, twoD), device=card)
    qq[torch.arange(B), torch.arange(B) % 3] = 1.0
    c = torch.zeros(Sp, device=card)
    valid = i < Sp - 3000
    _same_pool(fused_topk, qq.to(torch.bfloat16), GT, c, valid, kappa)


@pytest.mark.parametrize("B", [1, 40])
def test_fused_topk_guessed_window_misses(card, B):
    """Each slab's scores shifted by 0, +4096 or -4096 at random, so that
    where a cluster's next slab has another shift than its last one, the
    window guessed from the last kappa-th key misses and the select starts
    over, and where it has the same, the guess holds: the same pools, ids
    and all, as the plain version's on dyadic scores."""
    from rag_cobweb_tpu_torch.ops import fused_topk
    qq, GT, c, valid = _dyadic_sweep(card, torch.bfloat16, B, 64, 40 * 2048,
                                     40 * 2048 - 700, B)
    g = torch.Generator(device=card).manual_seed(B)
    shift = 4096.0 * torch.randint(-1, 2, (40,), generator=g, device=card)
    c = c + shift.repeat_interleave(2048)
    _same_pool(fused_topk, qq, GT, c, valid, 300)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("twoD", [64, 98])
def test_fused_kernels_take_an_unaligned_query_batch(card, twoD, dtype):
    """qq contiguous but one element off a 16-byte boundary (a view into a
    flat buffer): the wrappers copy it to padded, aligned rows for TMA, so
    both kernels give the plain version's pools, ids and all, from either
    entry."""
    from rag_cobweb_tpu_torch.ops import fused_topk
    qq, GT, c, valid = _dyadic_sweep(card, dtype, 33, twoD, 4096, 3900,
                                     twoD)
    buf = torch.zeros(qq.numel() + 1, dtype=qq.dtype, device=card)
    buf[1:] = qq.flatten()
    qu = buf[1:].view(qq.shape)
    assert qu.is_contiguous() and qu.data_ptr() % 16
    _same_pool(fused_topk, qu, GT, c, valid, 100)
    _group_holds(fused_topk, qu, GT, c, valid, 3, exact=True)


def _per_slab_top(fused_topk, qq, GT, c, valid, k):
    """The per-slab kernel's pools (every row's score from the same sweep)
    and their top k by (score desc, id asc)."""
    s, i = fused_topk.slab_topk(qq, GT, c, valid, min(k, fused_topk.SLAB))
    B = qq.shape[0]
    return fused_topk.select_keys(s.permute(1, 0, 2).reshape(B, -1),
                                  i.permute(1, 0, 2).reshape(B, -1), k)


@pytest.mark.parametrize("B,twoD,Sp,S,k,cap,dup", [
    (37, 99, 8192, 7000, 64, 128, 0),
    (130, 128, 32768, 30000, 512, 1024, 0),
    (200, 320, 20480, 20000, 1024, None, 0),
    (64, 256, 65536, 65536, 512, None, 30),
    (20, 64, 4096, 4096, 2048, 4096, 0),
    (8, 64, 8192, 1000, 1500, 2048, 0),
    (65, 250, 16384, 16000, 100, None, 0)])
def test_pruned_pool_matches_the_per_slab_kernel(card, B, twoD, Sp, S, k,
                                                 cap, dup):
    """The pruned path's kernels on dyadic scores (many exact ties; runs of
    ``dup`` equal rows inside a group) against the per-slab kernel's pools
    on the same card: the same top k, scores and ids (ties to the lower
    id), the plain version's scores, at least min(k, live rows) survivors
    a query, the same answer over repeated calls, and one count on
    ``launch.slab_topk_pruned`` a call; ragged 2D and B, to 2D = 320."""
    from rag_cobweb_tpu_torch.ops import fused_topk
    qq, GT, c, valid = _dyadic_sweep(card, torch.bfloat16, B, twoD, Sp, S,
                                     B + k)
    if dup:
        rows = torch.arange(Sp, device=card) // dup * dup
        GT, c = GT[:, rows].contiguous(), c[rows].contiguous()
    n0 = _launches("slab_topk_pruned")
    outs = []
    for _ in range(3):
        pend = fused_topk.pool_sweep(qq, GT, c, valid, k, pruned=True,
                                     cap=cap)
        outs.append(fused_topk.pool_select(pend))
    assert _launches("slab_topk_pruned") == n0 + 3
    rs, ri = _per_slab_top(fused_topk, qq, GT, c, valid, k)
    torch.cuda.synchronize()
    for ts, ti in outs:
        assert torch.equal(ts, rs)
        fin = torch.isfinite(rs)
        assert torch.equal(ti[fin], ri[fin])
        assert bool((ti[~fin] == -1).all())
    assert bool((pend.pruned.survivors >= min(k, S)).all())
    ps, _ = fused_topk.pruned_select(fused_topk.pruned_sweep(
        qq.cpu(), GT.cpu(), c.cpu(), valid.cpu(), k, cap))[0]
    assert torch.equal(ps, rs.cpu())


@pytest.mark.parametrize("B,twoD,Sp", [(70, 200, 4096), (64, 320, 6144),
                                       (130, 64, 2048)])
def test_pruned_passes_score_every_row_bit_for_bit(card, B, twoD, Sp):
    """Passes A and B share the sweep: with k above pass A's group count
    the bound is 0 and every valid row survives pass B, so its survivors
    are every row's score; each 64-row group's maximum of those equals
    pass A's key, in pass A's layout, and each equals the per-slab
    kernel's score of the row, bit for bit."""
    from rag_cobweb_tpu_torch.ops import fused_topk
    g = torch.Generator(device=card).manual_seed(5)
    qq = torch.randn((B, twoD), generator=g, device=card).bfloat16()
    GT = (0.1 * torch.randn((twoD, Sp), generator=g, device=card)).bfloat16()
    c = torch.randn((Sp,), generator=g, device=card)
    S = Sp - 96
    valid = torch.arange(Sp, device=card) < S
    cap = fused_topk.prune_cap(Sp)
    k = fused_topk._groups(Sp // fused_topk.SLAB) + 1
    p = fused_topk.pruned_sweep(qq, GT, c, valid, k, cap)
    surv, cnt = p.buffer, p.survivors
    torch.cuda.synchronize()
    assert bool((cnt == S).all())
    row = 0xFFFFFFFF - (surv & 0xFFFFFFFF)
    keys = torch.zeros((B, Sp + 1), dtype=torch.int64, device=card)
    live = torch.arange(cap, device=card).view(1, -1) < cnt.view(-1, 1)
    keys.scatter_(1, torch.where(live, row, torch.full_like(row, Sp)),
                  (surv >> 32) & 0xFFFFFFFF)
    ninf = fused_topk.score_keys(torch.tensor(float("-inf"), device=card))
    keys = torch.where(valid, keys[:, :Sp], ninf)
    gs = keys.view(B, -1, 16, 2, 4).permute(0, 1, 3, 2, 4).reshape(
        B, -1, fused_topk.PRUNE_GROUP)
    assert torch.equal(gs.amax(dim=2), p.groups.long() & 0xFFFFFFFF)
    ks, ki = fused_topk.slab_topk(qq, GT, c, valid, fused_topk.SLAB)
    at = torch.zeros((B, Sp), dtype=torch.int64, device=card)
    at.scatter_(1, ki.permute(1, 0, 2).reshape(B, -1).long(),
                fused_topk.score_keys(ks.permute(1, 0, 2).reshape(B, -1)))
    assert torch.equal(torch.where(valid, at, 0), torch.where(valid, keys, 0))


def test_pruned_pool_overflow_stays_exact_and_is_counted(card, monkeypatch):
    """A buffer of 256 for a pool of 100: the first half of the queries are
    zero, so their scores are c alone and some 500 rows tie at the top,
    past the buffer; the others keep about k survivors.  The zero queries
    overflow, count on ``pool.overflow``, and ``pool_select`` answers them
    from their per-slab pools, three queries a chunk, exactly, beside the
    others' pruned pools."""
    from rag_cobweb_tpu_torch.ops import fused_topk
    from rag_cobweb_tpu_torch.utils import profiling
    B, Sp, k, cap = 16, 65536, 100, 256
    qq, GT, c, valid = _dyadic_sweep(card, torch.bfloat16, B, 64, Sp, Sp, 3)
    qq[:B // 2] = 0
    p0, n0 = _launches("slab_topk_pruned"), profiling.counter("pool.overflow")
    monkeypatch.setattr(fused_topk, "FALLBACK_BYTES",
                        3 * 48 * Sp // fused_topk.SLAB * k)
    pend = fused_topk.pool_sweep(qq, GT, c, valid, k, pruned=True, cap=cap)
    ts, ti = fused_topk.pool_select(pend)
    assert _launches("slab_topk_pruned") == p0 + 1
    over = pend.pruned.survivors > cap
    assert bool(over[:B // 2].all()) and not bool(over[B // 2:].any())
    assert profiling.counter("pool.overflow") - n0 == B // 2
    rs, ri = _per_slab_top(fused_topk, qq, GT, c, valid, k)
    assert torch.equal(ts, rs) and torch.equal(ti, ri)


def test_kernels_count_their_launches(card):
    from rag_cobweb_tpu_torch.ops import blocked_topk as bt
    from rag_cobweb_tpu_torch.ops import fused_topk, rerank
    names = ("slab_topk", "slab_group_topk", "rerank_lp", "blocked_topk")
    before = [_launches(n) for n in names]
    gt_args = (torch.ones((2, 4), device=card),
               torch.ones((4, 2048), device=card),
               torch.zeros(2048, device=card),
               torch.ones(2048, dtype=torch.bool, device=card))
    fused_topk.slab_topk(*gt_args, 3)
    fused_topk.slab_group_topk(*gt_args, 2)
    rerank.rerank_lp(torch.ones((3, 4), device=card),
                     torch.ones((2, 4), device=card),
                     torch.zeros((2, 5), dtype=torch.int32, device=card),
                     torch.zeros((2, 5), device=card), 1.0)
    bidx = _blocked_index(card, torch.bfloat16, 2, 16, 8, 16, 16, 0)
    q = torch.ones((3, 8), device=card)
    bt.blocked_topk(bidx, q, 4)
    bt.blocked_topk_tiled(bidx, q, 4)        # the same kernel and counter
    assert [_launches(n) for n in names] == [n + 1 for n in before[:3]] + [
        before[3] + 2]


def test_index_serves_the_same_ids_on_the_card(card):
    """The same forest served on the card (both kernels) and on the host
    (their plain versions), f32 serving index: equal ids."""
    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel
    data = synthetic_retrieval_hard(600, 50, 48, seed=5)
    w = PCAICAWhiteningModel.fit(data.corpus_embs, pca_dim=0.9,
                                 ica_max_iter=200, seed=0)
    out = []
    for dev in ("cpu", card):
        db = CobwebIndex(config=TreeConfig(dim=w.dim_out), n_subtrees=4,
                         whitener=w, device=dev)
        db.blocked_threshold = 64
        db.fused_dtype = "float32"
        db.add_sentences([None] * len(data.corpus_embs), data.corpus_embs)
        out.append(db.query_ids(data.query_embs, 10, rerank=32).cpu())
    recall = [np.mean([t in row for t, row in
                       zip(data.target_ids, ids.numpy())]) for ids in out]
    assert recall[0] == recall[1]


@pytest.mark.parametrize("budget", [None, 4])
def test_forest_build_on_the_card_equals_the_host(card, budget):
    """The card's build (each descent step replayed from a captured CUDA
    graph, recaptured when capacity grows) gives the host's eager forest:
    same structure and leaf ids, statistics to float32 rounding."""
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.tree import state_to_numpy
    from rag_cobweb_tpu_torch.parallel.vforest import VForest
    rng = np.random.default_rng(0)
    D = 16
    xs = (rng.normal(scale=2.0, size=(10, D))[rng.integers(0, 10, 400)]
          + 0.5 * rng.normal(size=(400, D))).astype(np.float32)
    forests = []
    for dev in ("cpu", card):
        vf = VForest(TreeConfig(dim=D), n_subtrees=4, capacity_per_tree=32,
                     device=dev)
        if budget:
            vf._budget = budget
        for part in np.array_split(xs, 3):
            vf.add(part)
        forests.append(vf)
    host, dev = forests
    np.testing.assert_array_equal(dev._leaf_global(), host._leaf_global())
    a, b = state_to_numpy(host.state), state_to_numpy(dev.state)
    for f in ("parent", "children", "n_children", "free_stack", "free_top",
              "n_alloc", "root", "counts"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for f in ("means", "m2s"):
        np.testing.assert_allclose(a[f], b[f], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["fit", "ifit"])
def test_single_tree_on_the_card_equals_the_host(card, mode):
    """The single tree built on the card (one lane, each descent step
    replayed from a CUDA graph, recaptured as capacity grows) gives the
    host's tree slot for slot and the same leaves; statistics to float32
    rounding."""
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.tree import CobwebTree
    rng = np.random.default_rng(1)
    D = 16
    xs = (rng.normal(scale=2.0, size=(8, D))[rng.integers(0, 8, 300)]
          + 0.5 * rng.normal(size=(300, D))).astype(np.float32)
    trees, leaves = [], []
    for dev in ("cpu", card):
        t = CobwebTree(TreeConfig(dim=D), capacity=16, device=dev)
        if mode == "fit":
            lv = np.concatenate([t.fit(p, batch_size=64)
                                 for p in np.array_split(xs, 3)])
        else:
            lv = np.asarray([t.ifit(x) for x in xs])
        trees.append(t.host_arrays())
        leaves.append(lv)
    np.testing.assert_array_equal(leaves[1], leaves[0])
    a, b = trees
    for f in ("parent", "children", "n_children", "free_stack", "free_top",
              "n_alloc", "root", "counts"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for f in ("means", "m2s"):
        np.testing.assert_allclose(a[f], b[f], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("threshold,fused_dtype,rerank",
                         [(8192, "float32", 32), (8192, "float32", 0),
                          (64, "float32", 32), (64, "float32", 0),
                          (64, "bfloat16", 32)])
def test_single_tree_serves_the_same_ids_on_the_card(card, threshold,
                                                     fused_dtype, rerank):
    """The single-tree CobwebIndex built and served on the card and on
    the host from the same rows: the same leaves, and the same served ids
    below ``blocked_threshold`` (path scores in PyTorch, then kernel 5)
    and on the fused branch (kernel 1, bf16 or f32, then kernel 5; at
    rerank=0 kernel 1's f32 entry alone); with the bf16 index the same
    recall (bf16 sums may reorder near-ties inside the pool)."""
    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.ops import fused_topk, rerank as rr
    from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel
    data = synthetic_retrieval_hard(400, 50, 48, seed=6)
    w = PCAICAWhiteningModel.fit(data.corpus_embs, pca_dim=0.9,
                                 ica_max_iter=200, seed=0)
    rows = w.transform(data.corpus_embs).astype(np.float32)
    qs = w.transform(data.query_embs).astype(np.float32)
    out, leaves = [], []
    for dev in ("cpu", card):
        db = CobwebIndex(corpus_embeddings=rows, device=dev)
        db.blocked_threshold = threshold
        db.fused_dtype = fused_dtype
        k1, k5 = _launches("slab_topk"), _launches("rerank_lp")
        out.append(db.query_ids(qs, 10, rerank=rerank).cpu().numpy())
        leaves.append(db.leaf_of_sentence)
    assert leaves[1] == leaves[0]
    if dev == card and threshold < len(rows):
        assert _launches("slab_topk") > k1
    if rerank:
        assert _launches("rerank_lp") > k5
    if fused_dtype == "float32" and rerank:
        np.testing.assert_array_equal(out[1], out[0])
    elif fused_dtype == "float32":     # raw path-score order: ties permute
        assert all(set(a) == set(b) for a, b in zip(out[1], out[0]))
    else:
        recall = [np.mean([t in row for t, row in
                           zip(data.target_ids, ids)]) for ids in out]
        assert recall[1] == recall[0]


def test_flagship_path_serves_the_hosts_ids_on_the_card(card):
    """The flagship path end to end from raw rows on a hard synthetic
    corpus (whitener in the wrapper, an 8-lane forest, the bf16 fused
    index, an exact re-rank pool), once on the card and once on the host:
    the same whitened rows, the same forest slot for slot, and the same
    served ids, except where the test shows the two ids as ties (kernel
    5's keys within 1e-5 of their terms at the 10th place, or path scores
    within 1e-3 of the pool's last, where bf16 products summed in another
    order may take either)."""
    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.index import fused_query_topk
    from rag_cobweb_tpu_torch.core.tree import state_to_numpy
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.ops import fused_topk, rerank
    from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel
    data = synthetic_retrieval_hard(3000, 300, 128, seed=11)
    w = PCAICAWhiteningModel.fit(data.corpus_embs, pca_dim=0.96,
                                 ica_max_iter=200, seed=0)
    raw = data.corpus_embs
    assert torch.equal(w.transform_torch(torch.as_tensor(raw, device=card))
                       .cpu(), w.transform_torch(torch.as_tensor(raw)))
    k, pool = 10, 256
    dbs, out = [], []
    for dev in ("cpu", card):
        db = CobwebIndex(config=TreeConfig(dim=w.dim_out), n_subtrees=8,
                         whitener=w, device=dev)
        db.blocked_threshold = 64
        db.add_sentences([None] * len(raw), raw)
        out.append(db.query_ids(data.query_embs, k, rerank=pool)
                   .cpu().numpy())
        dbs.append(db)
    host, dev = dbs
    np.testing.assert_array_equal(dev.forest._leaf_global(),
                                  host.forest._leaf_global())
    a, b = state_to_numpy(host.forest.state), state_to_numpy(dev.forest.state)
    for f in ("parent", "children", "n_children", "counts"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    differ = np.nonzero((out[0] != out[1]).any(axis=1))[0]
    pv = float(dev.cfg.prior_var)
    D = raw.shape[1]
    for qi in differ:
        qs = torch.as_tensor(data.query_embs[qi:qi + 1], device=card)
        q = w.transform_torch(qs)
        fidx = dev._fused_index()
        qq = fused_topk.query_terms(q, fidx.GT.dtype)
        full = fused_topk.slab_scores_plain(qq, fidx.GT, fidx.c, fidx.valid,
                                            float("-inf"))[0].reshape(-1)
        cs, cand = fused_query_topk(fidx, q, pool)
        last = float(cs[0, -1])
        ids = torch.as_tensor(np.union1d(out[0][qi], out[1][qi]),
                              device=card)
        keys = rerank.rerank_lp_plain(
            dev._emb_device(), qs, ids.view(1, -1).to(torch.int32),
            torch.zeros((1, len(ids)), device=card), pv)[0]
        kth = float(torch.topk(keys, k).values[-1])
        tol = 1e-5 * (abs(kth) + 0.5 * D * abs(math.log(pv)))
        for sid in set(out[0][qi]) ^ set(out[1][qi]):
            j = int((ids == int(sid)).nonzero()[0, 0])
            key_tie = abs(float(keys[j]) - kth) <= tol
            pool_tie = abs(float(full[int(sid)]) - last) <= \
                1e-3 * (1 + abs(last))
            assert key_tie or pool_tie, (
                f"query {qi}: id {sid} differs and is no tie (key "
                f"{float(keys[j])} vs 10th {kth}; path score "
                f"{float(full[int(sid)])} vs pool's last {last})")


@pytest.mark.parametrize("B,c", [(1, 300), (33, 300), (64, 2048)])
def test_backstop_pool_through_kernel_1_matches_plain(card, B, c):
    """The whitener-mode backstop pool on the card (kernel 1 over a bf16
    store in GT layout, one launch) against its plain version on the
    host: the same finite count, rows at or past ``n_valid`` never
    pooled and the rest -inf, scores within 1e-3 + 1e-3 |score|, ids
    equal except among scores tied within that with the pool's last."""
    from rag_cobweb_tpu_torch.core.index import backstop_topk
    from rag_cobweb_tpu_torch.ops import fused_topk
    g = torch.Generator(device=card).manual_seed(B + c)
    Dw, Sw, n_valid = 128, 6144, 5000
    GT = torch.randn((Dw, Sw), generator=g, device=card).to(torch.bfloat16)
    GT[:, 5800:] = 0                       # the store's zero padding
    half = 0.5 * torch.sum(torch.square(GT.float()), dim=0)
    q = torch.randn((B, Dw), generator=g, device=card)
    before = _launches("slab_topk")
    ks, ki = backstop_topk(GT, half, q, c, n_valid, True)
    assert _launches("slab_topk") == before + 1
    ps, pi = backstop_topk(GT.cpu(), half.cpu(), q.cpu(), c, n_valid,
                           True)
    ks, ki = ks.cpu(), ki.cpu().long()
    fin = torch.isfinite(ps)
    assert torch.equal(fin, torch.isfinite(ks))
    assert int(fin.sum(1).min()) == min(c, n_valid)
    assert bool((ki[fin] < n_valid).all())
    torch.testing.assert_close(ks, ps, rtol=1e-3, atol=1e-3)
    last = ps[:, min(c, n_valid) - 1:min(c, n_valid)]
    full = (q.cpu().to(torch.bfloat16).float() @ GT.cpu().float()
            - half.cpu())
    for b in range(B):
        for sid in set(ki[b][fin[b]].tolist()) ^ set(pi[b][fin[b]].tolist()):
            assert abs(float(full[b, sid] - last[b, 0])) <= \
                1e-3 + 1e-3 * abs(float(last[b, 0]))


def test_backstop_and_tiers_serve_the_hosts_recall_on_the_card(card):
    """A whitener-mode forest with an explicit backstop pool, served on
    the card and on the host through adds that fill the pending tier and
    move it into the delta segment (limit lowered): the same recall at
    every step, the serving index kept, every added row found first, and
    on the card kernel 1 twice a chunk and kernel 5 twice (the union's
    re-rank and the pending tier)."""
    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.ops import fused_topk, rerank
    from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel
    data = synthetic_retrieval_hard(900, 60, 48, seed=6)
    w = PCAICAWhiteningModel.fit(data.corpus_embs[:600], pca_dim=0.9,
                                 ica_max_iter=200, seed=0)
    recalls = []
    for dev in ("cpu", card):
        db = CobwebIndex(config=TreeConfig(dim=w.dim_out), n_subtrees=4,
                         whitener=w, device=dev)
        db.blocked_threshold = 64
        db.fused_dtype = "float32"
        db.backstop_pool = 32
        db.stale_pending_limit = 100
        db.add_sentences([None] * 600, data.corpus_embs[:600])
        got = []
        n = 600
        for size in (0, 80, 120, 100):
            if size:
                fused = db._fused
                db.add_sentences([None] * size,
                                 data.corpus_embs[n:n + size])
                assert db._fused is fused
                n += size
            k1, k5 = _launches("slab_topk"), _launches("rerank_lp")
            ids = db.query_ids(data.query_embs, 10, rerank=24).cpu().numpy()
            if dev != "cpu":
                tiers = 1 if db._pending_sids else 0
                assert _launches("slab_topk") - k1 == 2
                assert _launches("rerank_lp") - k5 == 1 + tiers
            got.append(np.mean([t in row for t, row in
                                zip(data.target_ids, ids)]))
            if size:
                self_ids = db.query_ids(data.corpus_embs[n - size:n], 1,
                                        rerank=24).cpu().numpy()
                np.testing.assert_array_equal(self_ids[:, 0],
                                              np.arange(n - size, n))
        assert (db._unindexed_count(), db._delta_n) == (300, 200)
        recalls.append(got)
    assert recalls[0] == recalls[1]


@pytest.mark.parametrize("source", ["built", "loaded"])
def test_single_tree_serves_adds_on_the_card(card, source):
    """A single tree (built with its store, or loaded from JSON without
    one) served on the card and on the host through adds that fill the
    pending tier and move it into the delta segment (limit lowered), f32
    fused index: the same ids at every step, the serving index kept, and
    on the card the pending tier through kernel 5 (counted on
    ``launch.pending``) while rows wait in it."""
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    rng = np.random.default_rng(11)
    centers = rng.normal(scale=3.0, size=(8, 16))
    xs = (centers[rng.integers(0, 8, 400)]
          + 0.5 * rng.normal(size=(400, 16))).astype(np.float32)
    blob = CobwebIndex([f"s{i}" for i in range(300)], xs[:300],
                       device="cpu").dump_json()
    out = []
    for dev in ("cpu", card):
        db = (CobwebIndex(xs[:300].tolist(), xs[:300], device=dev)
              if source == "built" else CobwebIndex.load_json(blob,
                                                              device=dev))
        db.blocked_threshold = 64
        db.fused_dtype = "float32"
        db.stale_pending_limit = 40
        got = [db.query_ids(xs[::13], 5, rerank=16).cpu().numpy()]
        n = 300
        for size in (30, 30, 20):
            index = db._index
            db.add_sentences([None] * size, xs[n:n + size])
            n += size
            assert db._index is index
            p0 = _launches("pending")
            got.append(db.query_ids(xs[::13], 5, rerank=16).cpu().numpy())
            if dev != "cpu":
                assert _launches("pending") - p0 == (
                    1 if db._pending_sids else 0)
        assert (db._unindexed_count(), db._delta_n) == (80, 60)
        out.append(got)
    for a, b in zip(*out):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("routing", ["round_robin", "content"])
def test_small_forest_serves_on_the_card(card, routing):
    """A forest below ``blocked_threshold`` (400 rows, K=8) built and
    served on the card and on the host from the same rows: the same lanes
    and leaves, the same ids at the auto pool (kernel 5 on the card, one
    launch a query batch) and the same id sets in the raw leaf-lp order,
    rank scores within 1e-4; then an add, flushed and served alike."""
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.ops import rerank
    rng = np.random.default_rng(12)
    centers = rng.normal(scale=3.0, size=(8, 16))
    xs = (centers[rng.integers(0, 8, 440)]
          + 0.5 * rng.normal(size=(440, 16))).astype(np.float32)
    q = xs[::11] + 0.05
    out = []
    for dev in ("cpu", card):
        db = CobwebIndex(corpus_embeddings=xs[:400],
                         config=TreeConfig(dim=16), n_subtrees=8,
                         routing=routing, device=dev)
        n0 = _launches("rerank_lp")
        got = [db.query_ids(q, 10).cpu().numpy()]
        if dev != "cpu":
            assert _launches("rerank_lp") - n0 == 1
        got.append(np.sort(db.query_ids(q, 10, rerank=0).cpu().numpy(), 1))
        got.append(db.rank_scores(q, is_embedding=True).cpu().numpy())
        db.add_sentences([None] * 40, xs[400:])
        got.append(db.query_ids(xs[400:], 1).cpu().numpy())
        out.append((db.forest.shard_of, db.forest._leaf_global(), got))
    (lanes_h, leaves_h, host), (lanes_c, leaves_c, on_card) = out
    assert lanes_c == lanes_h
    np.testing.assert_array_equal(leaves_c, leaves_h)
    np.testing.assert_array_equal(on_card[0], host[0])
    np.testing.assert_array_equal(on_card[1], host[1])
    np.testing.assert_allclose(on_card[2], host[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(on_card[3][:, 0], np.arange(400, 440))
    np.testing.assert_array_equal(host[3][:, 0], np.arange(400, 440))


@pytest.mark.parametrize("lanes,routing", [(1, "round_robin"),
                                           (8, "round_robin"),
                                           (8, "content")])
def test_predict_on_the_card_equals_the_host(card, lanes, routing):
    """``predict`` (the packed beam: a single tree's, a forest's lane-fair
    one, a content-routed forest's over its 2 nearest lanes) built and
    served on the card and on the host from the same rows: the same ids
    but at ties of the leaf log-prob (``probes.hold_beam``), and no kernel
    launched on the card; ``predict_fast`` the same ids."""
    from rag_cobweb_tpu_torch.bench import probes
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    rng = np.random.default_rng(13)
    centers = rng.normal(scale=3.0, size=(8, 16))
    xs = (centers[rng.integers(0, 8, 300)]
          + 0.5 * rng.normal(size=(300, 16))).astype(np.float32)
    q = xs[::7] + 0.05
    out = {}
    for dev in ("cpu", card):
        db = CobwebIndex(corpus_embeddings=xs, config=TreeConfig(dim=16),
                         n_subtrees=lanes, routing=routing, device=dev)
        lpq = 2 if routing == "content" else None
        probes.zero_counters()
        beam = db.predict(q, k=10, return_ids=True, is_embedding=True,
                          beam_width=16, beam_lanes=lpq)
        if dev != "cpu":
            assert not any(probes.read_counters().values())
        out[str(dev)] = (db, beam, db.predict_fast(q, k=10, return_ids=True,
                                                   is_embedding=True))
    (_, hb, hf), (cdb, cb, cf) = out["cpu"], out[str(card)]
    probes.hold_beam(cdb, q, hb, cb)
    assert cf == hf


@pytest.mark.parametrize("B,D,S,C", [(1, 768, 3000, 300),
                                     (32, 50, 3000, 300),
                                     (1024, 768, 3000, 300),
                                     (1024, 766, 3000, 300),
                                     (1024, 50, 500, 300),
                                     (32, 768, 1 << 20, 1024),
                                     (1024, 768, 1 << 20, 1024)])
def test_rerank_bf16_entry_matches_plain(card, B, D, S, C):
    """Kernel 5's bf16-row entry (the bf16 re-rank store) against its
    plain version (the gathered rows upcast): B = 1, 32 and 1024, D = 50,
    766 (scalar loads) and 768 (16-byte loads of 8 values), ids repeated
    within a query's list, one query with every candidate -inf, and 1M
    rows; keys within 1e-5 of the f32 entry's tolerance, one launch of
    the bf16 entry each."""
    from rag_cobweb_tpu_torch.ops import rerank
    g = torch.Generator(device=card).manual_seed(B + D + C + 7)
    emb = torch.randn((S, D), generator=g, device=card).to(torch.bfloat16)
    q = torch.randn((B, D), generator=g, device=card)
    cand = torch.randint(0, S, (B, C), generator=g, device=card,
                         dtype=torch.int32)
    cand[:, 1::3] = cand[:, ::3][:, :cand[:, 1::3].shape[1]]
    cs = torch.randn((B, C), generator=g, device=card)
    cs[:, ::7] = -math.inf
    cs[B // 2] = -math.inf
    pv = 1.0 / (2.0 * math.e * math.pi)
    n0, b0 = _launches("rerank_lp"), _launches("rerank_lp_bf16")
    lk = rerank.rerank_lp(emb, q, cand, cs, pv)
    assert (_launches("rerank_lp") - n0,
            _launches("rerank_lp_bf16") - b0) == (1, 1)
    lp = rerank.rerank_lp_plain(emb, q, cand, cs, pv)
    torch.cuda.synchronize()
    fin = torch.isfinite(lp)
    assert torch.equal(fin, torch.isfinite(lk))
    assert not bool(fin[B // 2].any())
    torch.testing.assert_close(lk[fin], lp[fin], rtol=1e-5, atol=0.0)
    dup = cand[:, 1::3] == cand[:, ::3][:, :cand[:, 1::3].shape[1]]
    both = fin[:, 1::3] & fin[:, ::3][:, :dup.shape[1]]
    assert torch.equal(lk[:, 1::3][dup & both],
                       lk[:, ::3][:, :dup.shape[1]][dup & both])


def _tool_forest(card, dev, n=600, D=16, lanes=8, **kw):
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    rng = np.random.default_rng(17)
    centers = rng.normal(scale=3.0, size=(8, D))
    xs = (centers[rng.integers(0, 8, n + 64)]
          + 0.5 * rng.normal(size=(n + 64, D))).astype(np.float32)
    db = CobwebIndex(config=TreeConfig(dim=D), n_subtrees=lanes,
                     device=dev, **kw)
    db.add_sentences([None] * n, xs[:n])
    db.blocked_threshold = 256        # the fused engine, kernels 1 and 5
    db.fused_dtype = "float32"
    return db, xs


def test_compress_and_offload_on_the_card(card):
    """A forest built on the card: ``compress_stats`` makes new state
    tensors, so the next add recaptures the step graph (never replays the
    f32 one); ``offload_state`` frees the state's device bytes into pinned
    host memory, serving keeps its ids, and an add brings the state back
    before the descent; each added row comes back first as itself."""
    from rag_cobweb_tpu_torch.core import tree as tree_mod
    db, xs = _tool_forest(card, card)
    q = xs[:600:7] + 0.05
    f = db.forest
    graph = f._graph
    db.compress_stats()
    assert f.state.means.dtype == torch.bfloat16 and f._graph is None
    ids0 = db.query_ids(q, 10, rerank=32).cpu().numpy()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)
    nbytes = tree_mod.state_bytes(f.state)
    db.offload_state()
    torch.cuda.synchronize()
    assert before - torch.cuda.memory_allocated(card) >= nbytes
    assert f.state.device.type == "cpu" and f.state.means.is_pinned()
    np.testing.assert_array_equal(
        db.query_ids(q, 10, rerank=32).cpu().numpy(), ids0)
    assert f.state.device.type == "cpu"
    db.add_sentences([None] * 32, xs[600:632])
    assert f.state.device.type == "cuda"
    assert f._graph is not None and f._graph is not graph
    assert f._graph.matches(f.state)
    got = db.query_ids(xs[600:632], 1, rerank=32).cpu().numpy()[:, 0]
    np.testing.assert_array_equal(got, np.arange(600, 632))


def test_cpu_build_promoted_to_the_card(card):
    """``build_device="cpu"``: the forest's state, the inserts and the
    stores stay on the host; ``promote_build_device`` moves the forest and
    every store and index to the card, which serves the host's ids, and
    the build equals a card build of the same rows leaf for leaf."""
    host_db, xs = _tool_forest(card, card, build_device="cpu")
    card_db, _ = _tool_forest(card, card)
    assert host_db.device.type == "cpu"
    assert host_db.forest.state.device.type == "cpu"
    assert host_db.forest.serve_device.type == "cuda"
    np.testing.assert_array_equal(host_db.forest._leaf_global(),
                                  card_db.forest._leaf_global())
    q = xs[:600:7] + 0.05
    want = host_db.query_ids(q, 10, rerank=32).numpy()
    host_db.promote_build_device()
    assert host_db.device.type == "cuda"
    assert host_db.forest.state.device.type == "cuda"
    assert host_db._emb_device().device.type == "cuda"
    assert host_db._fused.GT.device.type == "cuda"
    for x in (host_db, card_db):
        np.testing.assert_array_equal(
            x.query_ids(q, 10, rerank=32).cpu().numpy(), want)
    host_db.add_sentences([None] * 32, xs[600:632])
    got = host_db.query_ids(xs[600:632], 1, rerank=32).cpu().numpy()[:, 0]
    np.testing.assert_array_equal(got, np.arange(600, 632))


def test_bf16_store_serves_through_its_entry(card):
    """``emb_store_dtype = "bfloat16"`` on the card: the store is rebuilt
    in bf16, each served batch launches kernel 5's bf16 entry, and the ids
    equal the host's over the same bf16 store (its plain version)."""
    from rag_cobweb_tpu_torch.ops import rerank
    out = []
    for dev in ("cpu", card):
        db, xs = _tool_forest(card, dev)
        db.emb_store_dtype = "bfloat16"
        q = xs[:600:7] + 0.05
        b0 = _launches("rerank_lp_bf16")
        out.append(db.query_ids(q, 10, rerank=32).cpu().numpy())
        assert db._emb_device().dtype == torch.bfloat16
        if dev != "cpu":
            assert _launches("rerank_lp_bf16") - b0 == 1
    np.testing.assert_array_equal(out[1], out[0])


def _near_ties_only(rec: dict):
    """The rule ``bench/build_divergence.py``'s verdict set for card and
    host builds: every lane slot for slot equal, but a lane whose first
    differing decision is a tie or a near tie (its two values within the
    float32 rounding bound of their terms); never one beyond it."""
    assert rec["lanes_differing"] == [d["lane"] for d in
                                      rec["first_differences"]]
    for d in rec["first_differences"]:
        assert d["verdict"] in ("exact tie", "near tie"), d


@pytest.mark.parametrize("kind", ["zca", "pcazca"])
def test_zca_forests_serve_the_hosts_ids_on_the_card(card, kind, tmp_path):
    """A whitener-mode forest on a ZCA or PCA+ZCA whitener (the tree as
    wide as the raw rows), built on the card and on the host from the same
    whitened rows (``bench/build_divergence.py``, every step recorded):
    slot for slot equal but in lanes whose first difference is a tie or
    a near tie (``_near_ties_only``), the recorded card build equal to the
    one ``CobwebIndex`` makes (its steps replayed from a CUDA graph).
    Served on the card (an f32 fused index, kernels 1 and 5) and on its
    host copy (the saved file loaded on the CPU): the same ids, except
    where the re-rank keys of the two ids tie within 1e-5 of their
    terms."""
    from rag_cobweb_tpu_torch.bench import build_divergence as bd
    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
    from rag_cobweb_tpu_torch.core import tree as tree_mod
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.ops import fused_topk, rerank
    from rag_cobweb_tpu_torch.whitening import (PCAZCAWhiteningModel,
                                                ZCAWhiteningModel)
    data = synthetic_retrieval_hard(2000, 200, 64, seed=12)
    raw = data.corpus_embs
    w = (ZCAWhiteningModel.fit(raw) if kind == "zca"
         else PCAZCAWhiteningModel.fit(raw, pca_dim=0.96))
    assert w.dim_out == raw.shape[1]
    x = w.transform_torch(torch.as_tensor(raw, device=card))
    assert torch.equal(x.cpu(), w.transform_torch(torch.as_tensor(raw)))
    cfg = TreeConfig(dim=w.dim_out)
    host = bd.traced_build(x.cpu(), cfg, 8, "cpu")
    on_card = bd.traced_build(x, cfg, 8, card)
    _near_ties_only(bd.compare(host, on_card))
    db = CobwebIndex(config=cfg, n_subtrees=8, whitener=w, device=card)
    db.add_sentences([None] * len(raw), raw)
    arrays = tree_mod.state_to_numpy(db.forest.state)
    for f, a in arrays.items():
        np.testing.assert_array_equal(a, on_card.arrays[f], err_msg=f)
    path = str(tmp_path / "forest.npz")
    db.save(path)
    host = CobwebIndex.load(path, device="cpu")
    out = []
    for x in (host, db):
        x.blocked_threshold = 64
        x.fused_dtype = "float32"
        l0, r0 = _launches("slab_topk_f32"), _launches("rerank_lp")
        out.append(x.query_ids(data.query_embs, 10, rerank=128)
                   .cpu().numpy())
        if x.device.type == "cuda":
            assert _launches("slab_topk_f32") > l0
            assert _launches("rerank_lp") > r0
    pv, D = float(db.cfg.prior_var), raw.shape[1]
    for qi in np.nonzero((out[0] != out[1]).any(axis=1))[0]:
        qs = torch.as_tensor(data.query_embs[qi:qi + 1], device=card)
        ids = torch.as_tensor(np.union1d(out[0][qi], out[1][qi]),
                              device=card)
        keys = rerank.rerank_lp_plain(
            db._emb_device(), qs, ids.view(1, -1).to(torch.int32),
            torch.zeros((1, len(ids)), device=card), pv)[0]
        kth = float(torch.topk(keys, 10).values[-1])
        tol = 1e-5 * (abs(kth) + 0.5 * D * abs(math.log(pv)))
        for sid in set(out[0][qi]) ^ set(out[1][qi]):
            j = int((ids == int(sid)).nonzero()[0, 0])
            assert abs(float(keys[j]) - kth) <= tol, (qi, sid)


def test_card_build_equals_the_host_build_but_at_near_ties(card):
    """Phase 3g (d)'s forest (``bench/build_divergence.py`` case (a): the
    first 4096 rows of phase 3e's corpus, PCA+ICA at 0.96, 32 lanes)
    built on the card and on the host with every step recorded: each lane
    slot for slot equal, or its first difference a tie or a near tie; the
    recorded card build equal to the CUDA-graph build."""
    from rag_cobweb_tpu_torch.bench import build_divergence as bd
    rec = bd.run_case("a", device=card)
    assert rec["recorded_equals_graph_build"]
    _near_ties_only(rec)


def _train_db(card, n=300, D=24, seed=0, texts=None):
    """A single tree of ``n`` clustered rows on the card and its host copy
    (saved and loaded with ``device="cpu"``), with the rows."""
    import tempfile
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=3.0, size=(12, D))
    xs = (centers[np.arange(n) % 12]
          + 0.3 * rng.normal(size=(n, D))).astype(np.float32)
    db = CobwebIndex(corpus=texts, corpus_embeddings=xs,
                     config=TreeConfig(dim=D), device=card)
    with tempfile.TemporaryDirectory() as tmp:
        db.save(tmp + "/db.npz")
        host = CobwebIndex.load(tmp + "/db.npz", device="cpu")
    return db, host, xs


def _hold(rec):
    assert rec["ok"], rec["fails"]
    assert rec["steps"] == 5


def test_query_trainer_on_the_card_equals_the_host(card):
    """Five ``CobwebQueryTrainer`` steps on the card and on a host copy
    (the same parameters and batches): metrics and parameters by
    ``bench/train_steps.hold``'s rule, the CPU tests' tolerances."""
    from rag_cobweb_tpu_torch.bench import train_steps
    from rag_cobweb_tpu_torch.training import CobwebQueryTrainer
    db, host, xs = _train_db(card)
    rng = np.random.default_rng(1)
    gold = rng.choice(len(xs), 120, replace=False)
    q = (xs[gold] @ np.linalg.qr(rng.normal(size=(24, 24)))[0]).astype(
        np.float32)
    tr = CobwebQueryTrainer(db, in_dim=24, hidden_dim=512, lr=1e-3)
    assert tr.head.Dense_0.weight.device.type == card.type
    _hold(train_steps.hold(tr, train_steps.host_copy(tr, host),
                           train_steps.query_steps(q, gold)))


def test_e2e_trainer_on_the_card_equals_the_host(card):
    """Five ``EndToEndQueryTrainer`` steps at the JAX defaults (vocab 8192,
    d_model 128, 2 layers, max_len 32), an empty text among the queries:
    loss and the encoder's gradient norm per step, then the parameters."""
    from rag_cobweb_tpu_torch.bench import train_steps
    from rag_cobweb_tpu_torch.training import EndToEndQueryTrainer
    texts = [f"cluster{r % 12} item{r}" for r in range(300)]
    db, host, _ = _train_db(card, texts=texts)
    q_texts = [f"find {t}" if r % 7 else "" for r, t in enumerate(texts)]
    tr = EndToEndQueryTrainer(db)
    _hold(train_steps.hold(tr, train_steps.host_copy(tr, host),
                           train_steps.e2e_steps(q_texts, np.arange(300),
                                                 8192, 32)))


def test_vicreg_on_the_card_equals_the_host(card):
    """Five ``VICRegWhitener`` steps at its defaults (768 -> 128, hidden
    1024, batches of 256)."""
    from rag_cobweb_tpu_torch.bench import train_steps
    from rag_cobweb_tpu_torch.training import VICRegWhitener
    rng = np.random.default_rng(2)
    X = (rng.normal(size=(1280, 768)) @ rng.normal(size=(768, 768))
         / 28.0).astype(np.float32)
    Y = X + 0.1 * rng.normal(size=X.shape).astype(np.float32)
    tr = VICRegWhitener(768, device=card)
    _hold(train_steps.hold(tr, train_steps.host_copy(tr),
                           train_steps.vicreg_steps(X, Y)))


def test_factorvae_on_the_card_equals_the_host(card):
    """Five ``FactorVAE`` steps at its defaults (z_dim 392, hidden 1024,
    gamma 10, lr 1e-4, batches of 256), the card's draws given to both."""
    from rag_cobweb_tpu_torch.bench import train_steps
    from rag_cobweb_tpu_torch.training import FactorVAE
    rng = np.random.default_rng(3)
    X = (rng.normal(size=(1280, 32)) @ rng.normal(size=(32, 768))
         / 5.0).astype(np.float32)
    tr = FactorVAE(768, device=card)
    _hold(train_steps.hold(tr, train_steps.host_copy(tr),
                           train_steps.factorvae_steps(tr, X)))


def test_classifier_on_the_card_equals_the_host(card):
    """The classifier fitted on the card and on the host from the same
    rows: the same tree and labels, ``predict_probs`` within 1e-5 with and
    without the ``max_nodes`` cut, and the same labels predicted."""
    from rag_cobweb_tpu_torch.core.classifier import CobwebClassifier
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=4.0, size=(6, 32))
    X = np.concatenate([c + 0.4 * rng.normal(size=(50, 32))
                        for c in centers]).astype(np.float32)
    y = [f"c{i // 50}" for i in range(len(X))]
    order = rng.permutation(len(X))
    X, y = X[order], [y[i] for i in order]
    clfs = [CobwebClassifier(TreeConfig(dim=32), capacity=1024, seed=0,
                             device=dev).fit(X[:240], y[:240])
            for dev in ("cpu", card)]
    a, b = (c.tree.host_arrays() for c in clfs)
    for f in ("parent", "children", "n_children", "counts"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert clfs[0].leaf_of_sentence == clfs[1].leaf_of_sentence
    for max_nodes in (None, 16):
        want, got = (c.predict_probs(X[240:], max_nodes) for c in clfs)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert clfs[1].predict(X[240:], max_nodes) == \
            clfs[0].predict(X[240:], max_nodes)
    assert clfs[1].score(X[240:], y[240:]) >= 0.9


def test_engines_on_the_card_equal_the_host(card):
    """``blocked_query_topk_rerank`` on an f32 blocked index (ids equal by
    tie group of the leaf log-prob, within 1e-4 of the row's largest),
    ``vforest_beam_topk`` (ids equal, or the differing row's beam scores
    tie within 1e-5 of the largest) and ``grouped_pool_topk`` on (8, 2^20)
    random scores (the same pool scores, every score its id's) on the card
    against the host."""
    from rag_cobweb_tpu_torch.core import index as tindex
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.parallel import vforest as tvf
    from torch_parity import assert_equal_by_tie_group
    rng = np.random.default_rng(3)
    centers = rng.normal(scale=2.0, size=(12, 24))
    xs = (centers[rng.integers(0, 12, 900)]
          + 0.5 * rng.normal(size=(900, 24))).astype(np.float32)
    forest = tvf.VForest(TreeConfig(dim=24), n_subtrees=4,
                         capacity_per_tree=512, device="cpu")
    forest.add(xs)
    q = xs[::9] + 0.05
    flat = forest.flat_index()
    res = []
    for dev in ("cpu", card):
        idx = flat if dev == "cpu" else flat._replace(**{
            f: getattr(flat, f).to(card) for f in flat._fields
            if isinstance(getattr(flat, f), torch.Tensor)})
        bidx = tindex.build_blocked_index(idx, block_size=128)
        res.append(tindex.blocked_query_topk_rerank(
            bidx, idx, torch.as_tensor(q, device=dev), 10, rerank=64))
    (ws, wi), (gs, gi) = [(s.cpu().numpy(), i.cpu().numpy())
                          for s, i in res]
    assert_equal_by_tie_group(wi, gi, ws, gs, rtol=1e-4)

    stacked = forest.build_index()
    on_card = stacked._replace(**{f: getattr(stacked, f).to(card)
                                  for f in stacked._fields})
    want = tvf.vforest_beam_topk(stacked, torch.as_tensor(q), 10)
    got = tvf.vforest_beam_topk(on_card, torch.as_tensor(q, device=card), 10)
    scores = tvf._vforest_beam(stacked, torch.as_tensor(q), 10, 32, 16)[0]
    for b in np.nonzero((want != got).any(axis=1))[0]:
        s = torch.sort(scores[:, b].reshape(-1), descending=True).values
        s = s[s > -1e38]
        assert bool(((s[:-1] - s[1:]) <= 1e-5 * s.abs().max()).any()), b

    g = torch.Generator(device=card).manual_seed(0)
    sc = torch.randn((8, 1 << 20), generator=g, device=card)
    gt, gid = tindex.grouped_pool_topk(sc, 512)
    ht, hid = tindex.grouped_pool_topk(sc.cpu(), 512)
    assert torch.equal(gt, sc.gather(1, gid))
    assert torch.equal(torch.sort(gt, dim=1).values.cpu(),
                       torch.sort(ht, dim=1).values)


def test_dryrun_multichip_on_the_card(card):
    """The multi-device dry run (``bench/multichip``) on 2 ranks on the
    cards: a card a rank over NCCL, or both on one card over gloo; every
    rank serves the same ids (the sharded forest, both TP engines through
    kernels 1 and 5, the composed forest) and ``fit_dp``'s loss falls."""
    from rag_cobweb_tpu_torch.bench import multichip
    rec = multichip.dryrun_multichip(2, "cuda", timeout=300)
    assert rec["backend"] == ("nccl" if torch.cuda.device_count() >= 2
                              else "gloo")
    assert rec["losses"][-1] < rec["losses"][0]


@pytest.mark.parametrize("arch", ["bert", "roberta", "gpt2", "t5",
                                  "t5-gated"])
def test_encoder_family_forest_on_the_card(card, arch, tmp_path,
                                           monkeypatch):
    """Each encoder architecture (2 layers, 64 wide, random weights from
    seed 0, the hash tokenizer) through ``chip_smoke.encoder_phase`` at
    2000 texts: 32 of them on the card held against a host copy (rtol
    1e-4, atol 1e-5, TF32 off); PCA+ICA fused on the card;
    ``encode_whiten_insert`` into an 8-lane forest served by the fused
    engine and the re-rank (``blocked_threshold`` and
    ``rerank_threshold`` lowered to 0, as at phase 3l's 10000 rows)
    through kernels 1 and 5, its ids held against the same pipeline
    in plain PyTorch (``probes.plain_check``), recall@10 within 0.005 of
    the exact scan's."""
    import importlib.util
    from pathlib import Path

    from rag_cobweb_tpu_torch.bench import probes
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent /
        "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    setup = CobwebIndex._setup

    def small_setup(self, *a, **k):
        setup(self, *a, **k)
        self.blocked_threshold = 0

    monkeypatch.setattr(CobwebIndex, "_setup", small_setup)
    monkeypatch.setattr(CobwebIndex, "rerank_threshold", 0)
    widths = dict(arch=arch.split("-")[0], hidden_size=64, n_layers=2,
                  n_heads=4, vocab_size=4096,
                  feed_forward_proj="gated-gelu" if "gated" in arch
                  else "relu")
    e = cs.encoder_phase(probes.zero_counters, probes.read_counters, "card",
                         tmp_path, widths=widths, n_corpus=2000,
                         n_queries=200, max_length=32, n_hold=32, n_lanes=8)
    w = e["window"]
    assert w["fused_topk"] > 0 and w["rerank_l2"] > 0, w
    assert w["fused_topk_f32"] == 0, w
    assert e["recall@10"] >= e["exact_recall@10"] - 0.005
    assert abs(e["recall@10"] - e["plain"]["plain_recall@10"]) <= 0.005
