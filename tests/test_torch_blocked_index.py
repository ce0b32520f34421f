"""Flat index, blocked index, blocked sweep entries and the blocked engine
of the PyTorch port against the JAX package.

A JAX VForest state is copied into the port through ``interop``; from the
same state both packages build the flat and blocked indexes.  Tolerances:
structure arrays, M, W, ``valid`` and ``sid_of_slot`` exactly (the same
host numpy work); float32 statistics within rtol=1e-5 (summation order
only); bf16 statistics within one bf16 rounding (rtol=2^-7).  The sweep
entries run on the JAX index's own arrays (``interop``), scores within
rtol=atol=1e-4 (as tests/test_index.py) and equal id sets.  The port
selects its pools exactly (``torch.topk``), so the JAX side runs with its
exact selection too (``approx_pool=False``; ``approx_max_k`` is exact on
the CPU anyway)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.core import index as jidx
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.core.wrapper import CobwebIndex as JIndex
from rag_cobweb_tpu.ops.pallas_query import (pallas_blocked_topk,
                                             pallas_blocked_topk_tiled)
from rag_cobweb_tpu.parallel.vforest import VForest as JForest
from rag_cobweb_tpu_torch import interop
from rag_cobweb_tpu_torch.core import index as tidx
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
from rag_cobweb_tpu_torch.ops import blocked_topk as bt

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def forests():
    rng = np.random.default_rng(11)
    D = 12
    centers = rng.normal(scale=2.0, size=(8, D))
    xs = (centers[rng.integers(0, 8, 360)]
          + 0.5 * rng.normal(size=(360, D))).astype(np.float32)
    jf = JForest(JCfg(dim=D), n_subtrees=3, capacity_per_tree=64, seed=0)
    jf.add(xs[:200])
    jf.add(xs[200:])
    st = jax.device_get(jf.state)
    meta = {"cfg": jf.cfg.to_json_dict(), "shard_of": jf.shard_of,
            "local_sid": jf.local_sid, "leaf_of_local": jf._leaf_of_local}
    tf = interop.forest_from_numpy(
        {k: np.asarray(v) for k, v in st._asdict().items()}, meta,
        device="cpu")
    return jf, tf, xs


@pytest.fixture(scope="module")
def blocked(forests):
    """The JAX f32 blocked index (block_size=32, node_pad=16) and the same
    arrays as a port BlockedIndex."""
    jf = forests[0]
    jb = jidx.build_blocked_index(jf.flat_index(), block_size=32,
                                  node_pad=16)
    tb = interop.blocked_index_from_numpy(
        {k: np.asarray(v) for k, v in jb._asdict().items()}, device="cpu")
    return jb, tb


def test_flat_index_matches_jax(forests):
    jf, tf, _ = forests
    want, got = jf.flat_index(), tf.flat_index()
    assert tf.flat_index() is got                 # cached until an add
    for f in ("paths", "path_weights", "sentence_order", "children",
              "leaf_sentence_start", "leaf_sentence_count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.paths_h, np.asarray(want.paths))
    np.testing.assert_array_equal(got.order_h,
                                  np.asarray(want.sentence_order))
    for f in ("inv_var_T", "mu_over_var_T", "const"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("source", ["port_flat", "jax_flat"])
def test_blocked_build_matches_jax(forests, dtype, source):
    """From the port's own flat index, or from the JAX flat index's arrays
    carried over with ``interop.prediction_index_from_numpy``.  The port
    zero-pads D (12 here) to a multiple of 8."""
    jf, tf, _ = forests
    jflat = jf.flat_index()
    if source == "port_flat":
        flat = tf.flat_index()
    else:
        flat = interop.prediction_index_from_numpy(
            {k: np.asarray(v) for k, v in jflat._asdict().items()},
            device="cpu")
    want = jidx.build_blocked_index(jflat, block_size=32, node_pad=16,
                                    dtype=jnp.dtype(dtype))
    got = tidx.build_blocked_index(flat, block_size=32, node_pad=16,
                                   dtype=getattr(torch, dtype))
    assert tuple(got.W.shape) == tuple(want.W.shape)      # NB, M, TS
    assert got.W.dtype == getattr(torch, dtype)
    for f in ("W", "valid", "sid_of_slot"):
        np.testing.assert_array_equal(
            getattr(got, f).float().numpy(),
            np.asarray(getattr(want, f)).astype(np.float32), err_msg=f)
    D = want.ivt_b.shape[2]
    assert got.ivt_b.shape[2] == -(-D // 8) * 8       # padded to 8s
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for f in ("ivt_b", "movt_b", "const_b"):
        g = getattr(got, f).float()
        if f != "const_b":
            assert not bool(g[..., D:].any()), f    # zero columns
            g = g[..., :D]
        np.testing.assert_allclose(
            g.numpy(), np.asarray(getattr(want, f)).astype(np.float32),
            rtol=rtol, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("k", [5, 16])
def test_blocked_query_topk_matches_jax(forests, blocked, k):
    xs = forests[2]
    jb, tb = blocked
    want_s, want_i = jidx.blocked_query_topk(jb, jnp.asarray(xs[:8]), k)
    got_s, got_i = tidx.blocked_query_topk(tb, torch.as_tensor(xs[:8]), k)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-4, atol=1e-4)
    for b in range(8):
        assert set(got_i[b].tolist()) == set(np.asarray(want_i)[b].tolist())


ENTRIES = {
    "blocked": (pallas_blocked_topk, bt.blocked_topk, {}),
    "tiled": (pallas_blocked_topk_tiled, bt.blocked_topk_tiled,
              {"block_k": 8}),
}


@pytest.mark.parametrize("k", [5, 40])
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_blocked_entries_match_pallas_interpret(forests, blocked, entry, k):
    """The plain versions behind both entries against the Pallas kernels
    in interpret mode, on a ragged batch of 7."""
    xs = forests[2]
    jb, tb = blocked
    jfn, tfn, kw = ENTRIES[entry]
    want_s, want_i = jfn(jb, jnp.asarray(xs[:7]), k, interpret=True, **kw)
    got_s, got_i = tfn(tb, torch.as_tensor(xs[:7]), k, **kw)
    assert got_i.dtype == torch.int32
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-4, atol=1e-4)
    for b in range(7):
        assert set(got_i[b].tolist()) == set(np.asarray(want_i)[b].tolist())


def test_exhausted_rounds_match_pallas_interpret(forests, blocked):
    """More rounds than the last block has valid slots: the extra rounds
    give NEG at slot 0 in both packages (JAX's argmax over an all-NEG
    row), so the whole merged pool, NEG entries included, is the same
    multiset of (score, sentence id)."""
    xs = forests[2]
    jb, tb = blocked
    NB, _, TS = tb.W.shape
    assert not bool(tb.valid[-1].all())
    want_s, want_i = pallas_blocked_topk(jb, jnp.asarray(xs[:3]), NB * TS,
                                         interpret=True, block_k=TS)
    got_s, got_i = bt.blocked_topk(tb, torch.as_tensor(xs[:3]), NB * TS,
                                   block_k=TS)
    assert bool((got_s <= bt.NEG / 2).any())
    for b in range(3):
        w = sorted(zip(np.asarray(want_s)[b].tolist(),
                       np.asarray(want_i)[b].tolist()))
        g = sorted(zip(got_s[b].tolist(), got_i[b].tolist()))
        assert [i for _, i in g] == [i for _, i in w]
        np.testing.assert_allclose([s for s, _ in g], [s for s, _ in w],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,kk", [(1, 8), (7, 64)])
def test_f32_block_candidates_match_pallas_interpret(B, kk):
    """The f32 function that the card's f32 kernel computes, and that its
    wrapper's zero padding of D to a multiple of 4 must keep: the plain
    ``block_candidates_plain`` against the JAX ``pallas_blocked_topk``
    (``Precision.HIGHEST``) in interpret mode, on dyadic inputs (every nlp
    term and score exact in f32 in any order), with D = 30 (no multiple of
    4), M = 112 (two 64-node chunks of the kernel, the second ragged) and a
    last block of 40 valid slots in 64 (kk = 64 runs into exhausted
    rounds, NEG at slot 0).  Every block's candidates, as (score, sentence
    id) pairs, within 1e-6 and with equal ids."""
    rng = np.random.default_rng(B + kk)
    NB, M, D, TS = 3, 112, 30, 64

    def dyadic(lo, hi, shape, den):
        return (rng.integers(lo, hi, shape) / den).astype(np.float32)

    W = np.where(rng.random((NB, M, TS)) < 6.0 / M,
                 dyadic(1, 3, (NB, M, TS), 2), 0.0).astype(np.float32)
    valid = np.ones((NB, TS), bool)
    valid[-1, 40:] = False
    arrays = dict(ivt_b=dyadic(1, 17, (NB, M, D), 16),
                  movt_b=dyadic(-8, 9, (NB, M, D), 16),
                  const_b=dyadic(-64, 65, (NB, M), 4), W=W, valid=valid,
                  sid_of_slot=rng.permutation(NB * TS).astype(
                      np.int32).reshape(NB, TS))
    q = dyadic(-8, 9, (B, D), 8)
    jb = jidx.BlockedIndex(**{k: jnp.asarray(v) for k, v in arrays.items()})
    want_s, want_i = pallas_blocked_topk(jb, jnp.asarray(q), NB * kk,
                                         interpret=True, block_k=kk)
    tb = tidx.BlockedIndex(**{k: torch.as_tensor(v)
                              for k, v in arrays.items()})
    qd, q2 = bt._queries(tb, torch.as_tensor(q))
    got_s, got_t = bt.block_candidates_plain(qd, q2, tb.ivt_b, tb.movt_b,
                                             tb.const_b, tb.W, tb.valid, kk)
    sid = tb.sid_of_slot[torch.arange(NB).view(NB, 1, 1), got_t.long()]
    assert bool((got_s <= bt.NEG / 2).any()) == (kk > 40)
    for b in range(B):
        w = sorted(zip((-np.asarray(want_s)[b]).tolist(),
                       np.asarray(want_i)[b].tolist()))
        g = sorted(zip((-got_s[:, b]).flatten().tolist(),
                       sid[:, b].flatten().tolist()))
        assert [i for _, i in g] == [i for _, i in w]
        np.testing.assert_allclose([s for s, _ in g], [s for s, _ in w],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [5, 12, 20])
def test_padded_width_serves_the_unpadded_results(D, dtype):
    """A blocked index keeps D a multiple of 8 (``pad_width``, as
    ``build_blocked_index`` pads it); the sweep entries and the PyTorch
    sweep pad the queries to it, and the zero columns change no score and
    no id.  Dyadic terms keep every sum exact in any order."""
    rng = np.random.default_rng(D)
    NB, M, TS, B = 3, 16, 32, 6

    def dyadic(lo, hi, shape, den):
        return torch.as_tensor(rng.integers(lo, hi, shape) / den,
                               dtype=torch.float32)

    valid = torch.ones((NB, TS), dtype=torch.bool)
    valid[-1, 20:] = False
    bare = tidx.BlockedIndex(
        ivt_b=dyadic(1, 17, (NB, M, D), 16).to(dtype),
        movt_b=dyadic(-8, 9, (NB, M, D), 16).to(dtype),
        const_b=dyadic(-64, 65, (NB, M), 4),
        W=(torch.as_tensor(rng.random((NB, M, TS)) < 0.3)
           .to(dtype).contiguous()),
        valid=valid,
        sid_of_slot=torch.arange(NB * TS, dtype=torch.int32).view(NB, TS))
    D8 = -(-D // 8) * 8
    padded = bare._replace(ivt_b=tidx.pad_width(bare.ivt_b, D8),
                           movt_b=tidx.pad_width(bare.movt_b, D8))
    assert padded.ivt_b.shape[2] % 8 == 0
    q = dyadic(-8, 9, (B, D), 8)
    for fn in (lambda b: bt.blocked_topk(b, q, 10, block_k=4),
               lambda b: bt.blocked_topk_tiled(b, q, 10),
               lambda b: tidx.blocked_query_topk(b, q, 10)):
        want_s, want_i = fn(bare)
        got_s, got_i = fn(padded)
        assert torch.equal(got_s, want_s)
        assert torch.equal(got_i, want_i)


@pytest.mark.parametrize("k", [4, 30])
def test_leaf_lp_rerank_matches_jax(forests, k):
    jf, tf, xs = forests
    rng = np.random.default_rng(3)
    cand = rng.integers(0, len(xs), (6, 30)).astype(np.int32)
    cs = rng.normal(size=(6, 30)).astype(np.float32)
    cs[:, ::7] = -np.inf
    want_s, want_i = jidx._leaf_lp_rerank(jf.flat_index(),
                                          jnp.asarray(xs[:6]),
                                          jnp.asarray(cand),
                                          jnp.asarray(cs), k)
    got_s, got_i = tidx._leaf_lp_rerank(tf.flat_index(),
                                        torch.as_tensor(xs[:6]),
                                        torch.as_tensor(cand),
                                        torch.as_tensor(cs), k)
    # lp sums terms of ~1e2 that cancel to ~1e1: f32 summation order
    # alone leaves ~1e-4 absolute
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-5, atol=1e-3)
    if k == 30:       # every candidate: the same multiset of ids
        for b in range(6):
            assert sorted(got_i[b].tolist()) == \
                sorted(np.asarray(want_i)[b].tolist())


# -- the wrapper's blocked engine, on the case of tests/test_wrapper.py's
#    Pallas routing test (8 clusters x 40 rows, D=16), in forest mode --

def _embs():
    rng = np.random.default_rng(11)
    D = 16
    centers = rng.normal(scale=4.0, size=(8, D)).astype(np.float32)
    return np.concatenate([c + 0.2 * rng.normal(size=(40, D))
                           for c in centers]).astype(np.float32)


def _pair(store: bool = True):
    embs = _embs()
    jdb = JIndex(config=JCfg(dim=16), n_subtrees=4)
    tdb = CobwebIndex(config=TreeConfig(dim=16), n_subtrees=4,
                      device="cpu")
    jdb.approx_pool = False
    for db in (jdb, tdb):
        db.store_embeddings = store
        db.blocked_threshold = 64
        db.pallas_threshold = 64
        db.blocked_dtype = "float32"
        db.use_fused = False
        db.add_sentences([None] * len(embs), embs)
    return jdb, tdb, embs


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("rerank", [16, 0], ids=["pool16", "path-order"])
@pytest.mark.parametrize("engine", ["blocked", "blocked_kernel"])
def test_blocked_engine_serves_the_jax_ids(pair, monkeypatch, engine,
                                           rerank):
    """``use_fused=False``, with and without ``use_pallas``: the served
    ids equal the JAX CobwebIndex's, and a spy on the ops entry shows
    which engine served."""
    jdb, tdb, embs = pair
    for db in (jdb, tdb):
        db.use_pallas = engine == "blocked_kernel"
    calls = {"kernel": 0, "sweep": 0}
    orig_k, orig_s = bt.blocked_topk, tidx.blocked_query_topk

    def spy_k(*a, **kw):
        calls["kernel"] += 1
        return orig_k(*a, **kw)

    def spy_s(*a, **kw):
        calls["sweep"] += 1
        return orig_s(*a, **kw)

    monkeypatch.setattr(bt, "blocked_topk", spy_k)
    monkeypatch.setattr(tidx, "blocked_query_topk", spy_s)
    want = np.asarray(jdb.query_ids(embs[:24], 10, rerank=rerank))
    got = tdb.query_ids(embs[:24], 10, rerank=rerank).numpy()
    if engine == "blocked_kernel":
        assert calls == {"kernel": 1, "sweep": 0}
    else:
        assert calls == {"kernel": 0, "sweep": 1}
    if rerank:
        np.testing.assert_array_equal(got, want)
    else:       # raw path-score order: ties may permute
        for b in range(len(want)):
            assert set(got[b]) == set(want[b])
    assert sum(b in got[b] for b in range(24)) >= 22


def test_kernel_serves_a_pool_above_its_block_candidates(pair, monkeypatch):
    """A re-rank pool larger than NB * pallas_block_k: the JAX package
    serves another engine (here its XLA blocked sweep); the port still
    serves the kernel, each block giving its exact top-pool, and the
    served ids equal the JAX ones."""
    jdb, tdb, embs = pair
    NB = tdb._blocked_index().ivt_b.shape[0]
    assert NB * tdb.pallas_block_k < 64
    for db in (jdb, tdb):
        db.use_pallas = True
    calls = {"kernel": [], "sweep": 0}
    orig_k, orig_s = bt.blocked_topk, tidx.blocked_query_topk

    def spy_k(*a, **kw):
        calls["kernel"].append(kw.get("block_k"))
        return orig_k(*a, **kw)

    def spy_s(*a, **kw):
        calls["sweep"] += 1
        return orig_s(*a, **kw)

    monkeypatch.setattr(bt, "blocked_topk", spy_k)
    monkeypatch.setattr(tidx, "blocked_query_topk", spy_s)
    want = np.asarray(jdb.query_ids(embs[:24], 5, rerank=64))
    got = tdb.query_ids(embs[:24], 5, rerank=64).numpy()
    assert calls == {"kernel": [0], "sweep": 0}
    np.testing.assert_array_equal(got, want)


def test_leaf_lp_engine_without_a_store():
    """No vector store: the pool is re-ranked by leaf log-probability, in
    both packages (the fused engine and the blocked one)."""
    jdb, tdb, embs = _pair(store=False)
    assert tdb._emb_device() is None
    q = embs[::13]
    for use_fused in (False, True):
        for db in (jdb, tdb):
            db.use_fused = use_fused
        js, ji = jdb._engine_topk(jnp.asarray(q), 5, 16, tie_noise=False)
        ts, ti = tdb._engine_topk(torch.as_tensor(q), 5, 16)
        # raw rows of scale ~4 over leaf variances near the prior (0.06):
        # terms of ~1e4 cancel to ~2e1, so f32 order leaves ~1e-3
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=5e-3)
        for b in range(len(q)):
            assert set(ti[b].tolist()) == set(np.asarray(ji)[b].tolist())
