"""The remaining engines of the PyTorch port against the JAX package:
``core/index.blocked_query_topk_rerank`` (the blocked sweep, its pool and
the leaf log-prob re-rank), ``parallel/vforest.vforest_beam_topk`` (the
per-lane oracle beam and its run expansion) and
``core/index.grouped_pool_topk`` (the strided two-level pool).

The indexes are the JAX package's, carried across (``interop``), so only
each engine's own arithmetic differs.  Tolerances: on an f32 blocked index
the re-ranked ids are equal and the scores within 1e-5 of the largest
magnitude of their terms (a leaf log-prob sums terms up to ~100x larger
than itself, in another order); on a bf16 one the ids are equal by tie
group of the leaf log-prob at that tolerance
(``torch_parity.assert_equal_by_tie_group``), as ``tests/test_index.py``
holds the bf16 engine against the f32 one.  The
forest beam's ids are equal.  The grouped pool has the same members as the
JAX function's wherever no two members of a strided group lie within
2^-19 of each other (the JAX key keeps 19 bits of mantissa); where they
do, the JAX function can pair a score with the other member's id, and the
port's pair is always consistent: each returned score is the score of the
returned id, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.core import index as jindex
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.core.tree import CobwebTree as JTree
from rag_cobweb_tpu.parallel import vforest as jvf
from rag_cobweb_tpu_torch import interop
from rag_cobweb_tpu_torch.core import index as tindex
from rag_cobweb_tpu_torch.parallel import forest as tforest
from rag_cobweb_tpu_torch.parallel import vforest as tvf

from torch_parity import assert_equal_by_tie_group

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built():
    """``tests/test_index.py``'s tree: 6 clusters x 15 rows at 16-d; the
    JAX prediction index and the same arrays as a port index."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=3.0, size=(6, 16))
    xs = np.concatenate([c + 0.25 * rng.normal(size=(15, 16))
                         for c in centers]).astype(np.float32)
    xs = xs[rng.permutation(len(xs))]
    tree = JTree(JCfg(dim=16), capacity=1024, seed=0)
    leaves = tree.fit(xs)
    jidx = jindex.build_index(tree, leaves)
    tidx = interop.prediction_index_from_numpy(
        {k: np.asarray(v) for k, v in jax.device_get(jidx)._asdict().items()},
        device="cpu")
    return jidx, tidx, xs


def leaf_terms(tidx, q, ids):
    """The magnitude of the terms of each id's leaf log-prob, |q| . |mu/var|
    + 0.5 q^2 . 1/var + |const| (the key is a sum of terms up to ~100x
    larger than itself, so float32 rounding scales with them)."""
    leaf = tindex._sentence_leaf_nodes(tidx)[torch.as_tensor(np.array(ids))]
    x = torch.as_tensor(q).unsqueeze(1)
    return (torch.sum(x.abs() * tidx.mu_over_var_T.T[leaf].abs(), -1)
            + 0.5 * torch.sum(x * x * tidx.inv_var_T.T[leaf], -1)
            + tidx.const[leaf].abs()).numpy()


@pytest.mark.parametrize("k,rerank", [(5, 32), (1, 8), (10, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_query_topk_rerank_matches_jax(built, dtype, k, rerank):
    jidx, tidx, xs = built
    jb = jindex.build_blocked_index(jidx, block_size=64,
                                    dtype=jnp.dtype(dtype))
    tb = tindex.build_blocked_index(tidx, block_size=64,
                                    dtype=getattr(torch, dtype))
    q = xs[::3] + 0.05
    ws, wi = jindex.blocked_query_topk_rerank(jb, jidx, jnp.asarray(q), k,
                                              rerank=rerank)
    gs, gi = tindex.blocked_query_topk_rerank(tb, tidx, torch.as_tensor(q),
                                              k, rerank=rerank)
    ws, wi = np.asarray(ws), np.asarray(wi)
    assert gi.shape == wi.shape
    terms = leaf_terms(tidx, q, wi).max(axis=1)
    if dtype == "float32":
        np.testing.assert_array_equal(gi.numpy(), wi)
        assert (np.abs(gs.numpy() - ws).max(axis=1) <= 1e-5 * terms).all()
    for b in range(len(q)):
        rtol = 1e-5 * terms[b] / max(float(np.abs(ws[b]).max()), 1.0)
        assert_equal_by_tie_group(wi[b:b + 1], gi.numpy()[b:b + 1],
                                  ws[b:b + 1], gs.numpy()[b:b + 1],
                                  rtol=rtol)
    # own rows come back first (the JAX test's check, at k >= 1)
    own = tindex.blocked_query_topk_rerank(tb, tidx, torch.as_tensor(xs),
                                           k, rerank=rerank)[1]
    assert all(b in own[b].tolist() for b in range(len(xs)))


@pytest.fixture(scope="module")
def stacked():
    """A 3-lane JAX forest of 220 rows at 8-d, its stacked index and the
    same arrays as a port StackedIndex."""
    rng = np.random.default_rng(5)
    centers = rng.normal(scale=2.0, size=(10, 8))
    xs = (centers[rng.integers(0, 10, 220)]
          + 0.5 * rng.normal(size=(220, 8))).astype(np.float32)
    jf = jvf.VForest(JCfg(dim=8), n_subtrees=3, capacity_per_tree=64,
                     seed=0)
    jf.add(xs[:100])
    jf.add(xs[100:])
    jidx = jf.build_index()

    def t(name):
        a = np.array(getattr(jidx, name))
        return torch.as_tensor(a.astype(np.int64) if a.dtype.kind in "iu"
                               else a)

    return jidx, tforest.StackedIndex(
        **{f: t(f) for f in tforest.StackedIndex._fields}), xs


@pytest.mark.parametrize("k,beam_width", [(1, 8), (10, 8), (10, 32),
                                          (64, 16), (500, 8)])
def test_vforest_beam_topk_matches_jax(stacked, k, beam_width):
    """The same ids (k=64 and 500 run past the live leaves: -1 padding);
    the per-lane beams' leaves equal and their scores within 1e-5 of the
    largest |score|."""
    jidx, tidx, xs = stacked
    q = xs[::7] + 0.05
    want = jvf.vforest_beam_topk(jidx, jnp.asarray(q), k,
                                 beam_width=beam_width)
    got = tvf.vforest_beam_topk(tidx, torch.as_tensor(q), k,
                                beam_width=beam_width)
    assert got.shape == want.shape == (len(q), k)
    np.testing.assert_array_equal(got, want)
    ws, wl = jvf._vforest_beam(jidx, jnp.asarray(q), k, beam_width, 16)
    gs, gl = tvf._vforest_beam(tidx, torch.as_tensor(q), k, beam_width, 16)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    live = np.asarray(wl) >= 0
    ws = np.asarray(ws)
    np.testing.assert_allclose(gs.numpy()[live], ws[live], rtol=0,
                               atol=1e-5 * np.abs(ws[live]).max())


def spaced_scores(B, Sp, seed):
    """Distinct multiples of 2^-10 in [-Sp/2048, Sp/2048), shuffled per
    row: two members of a group differ by at least 2^-10, far above 2^-19
    of their magnitude."""
    rng = np.random.default_rng(seed)
    return np.stack([(rng.permutation(Sp) - Sp // 2) / 1024.0
                     for _ in range(B)]).astype(np.float32)


@pytest.mark.parametrize("Sp,k", [(1 << 14, 64), (1 << 14, 512),
                                  (3000, 100), (1 << 14, 2000)],
                         ids=["k64", "k512", "group8", "k-past-groups"])
def test_grouped_pool_topk_members_match_jax(Sp, k):
    """Same members as the JAX function (Sp=3000 degrades the group to 8;
    k=2000 exceeds the 1024 groups, so both take the plain top-k), and
    every returned score is its id's."""
    scores = spaced_scores(3, Sp, seed=Sp + k)
    wt, wi = jindex.grouped_pool_topk(jnp.asarray(scores), k)
    gt, gi = tindex.grouped_pool_topk(torch.as_tensor(scores), k)
    wi = np.asarray(wi)
    assert gi.shape == wi.shape
    for b in range(len(scores)):
        assert set(gi[b].tolist()) == set(wi[b].tolist())
        assert torch.equal(gt[b], torch.as_tensor(scores[b])[gi[b]])
    np.testing.assert_array_equal(np.sort(gt.numpy(), axis=1),
                                  np.sort(np.asarray(wt), axis=1))


def test_grouped_pool_topk_membership():
    """The JAX test's own check on the port (``tests/test_fused_index.py``):
    an adjacent cluster of 64 dominant ids is kept whole (the stride puts
    them in separate groups), overlap with the exact top-512 at least
    0.99, and the returned scores are the returned ids' scores."""
    rng = np.random.default_rng(0)
    B, Sp, k = 4, 1 << 19, 512
    scores = rng.normal(size=(B, Sp)).astype(np.float32)
    j0 = 12345
    scores[:, j0:j0 + 64] += 20.0
    top, ids = tindex.grouped_pool_topk(torch.as_tensor(scores), k)
    ids = ids.numpy()
    exact = np.argsort(-scores, axis=1)[:, :k]
    for b in range(B):
        got = set(ids[b].tolist())
        assert all(j in got for j in range(j0, j0 + 64))
        assert len(got & set(exact[b].tolist())) / k >= 0.99
        np.testing.assert_array_equal(top[b].numpy(), scores[b, ids[b]])


def test_grouped_pool_topk_pairs_each_score_with_its_id():
    """Two members of one strided group within 2^-19: 1 + 15 ulp (member
    0) and 1.0 (member 5) share the JAX key's upper bits, so its packed max
    takes member 5's id while its float max takes member 0's score.  The
    port returns member 0 with its own score."""
    B, g, cols = 2, 16, 256
    scores = np.random.default_rng(4).uniform(
        -1, 0, size=(B, g * cols)).astype(np.float32)
    hi = np.float32(1.0) + np.float32(15 * 2.0 ** -23)
    scores[:, 0 * cols + 7] = hi
    scores[:, 5 * cols + 7] = 1.0
    wt, wi = jindex.grouped_pool_topk(jnp.asarray(scores), 4)
    wt, wi = np.asarray(wt), np.asarray(wi)
    assert wt[0, 0] == hi and wi[0, 0] == 5 * cols + 7
    assert scores[0, wi[0, 0]] != wt[0, 0]          # the JAX fault
    gt, gi = tindex.grouped_pool_topk(torch.as_tensor(scores), 4)
    assert float(gt[0, 0]) == hi and int(gi[0, 0]) == 7
    for b in range(B):
        assert torch.equal(gt[b], torch.as_tensor(scores[b])[gi[b]])
