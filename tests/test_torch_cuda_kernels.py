"""The port's CUDA kernels on the card, against their plain PyTorch
versions, and the fused engine on the card against the host.  Marked
``cuda``: they need an NVIDIA GPU (sm_90a) and nvcc, and skip without
one.  Run them on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda
"""

import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


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


def test_kernels_count_their_launches(card):
    from rag_cobweb_tpu_torch.ops import fused_topk, rerank
    n0, m0 = fused_topk.slab_topk.launches, rerank.rerank_lp.launches
    fused_topk.slab_topk(torch.ones((2, 4), device=card),
                         torch.ones((4, 2048), device=card),
                         torch.zeros(2048, device=card),
                         torch.ones(2048, dtype=torch.bool, device=card), 3)
    rerank.rerank_lp(torch.ones((3, 4), device=card),
                     torch.ones((2, 4), device=card),
                     torch.zeros((2, 5), dtype=torch.int32, device=card),
                     torch.zeros((2, 5), device=card), 1.0)
    assert fused_topk.slab_topk.launches == n0 + 1
    assert rerank.rerank_lp.launches == m0 + 1


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
