"""The beam engine of the PyTorch port (``core/index.py``: the oracle
``beam_search_topk``, ``build_beam_index``, the packed beam
``beam_pack_topk``, its lane-fair form ``beam_pack_topk_lanes``, and the
run expansions ``leaf_runs_to_sids``, ``leaves_to_sentence_ids`` and
``beam_query_ids``) against the JAX package, on a single tree and on a
4-lane flat forest built by the JAX package.

The JAX state is carried across (``interop``): the port's own
``build_index`` / ``build_flat_forest_index`` on that state must give the
beam structure the JAX package gives (``child_start``, ``child_count``
and the leaf runs exactly), and the JAX index's arrays, carried across as
they are, feed both packages' beam functions, so only the beam's own
arithmetic differs.  Tolerances: the f32 pack and const within 1e-6
relative (a concatenation: equal in fact); beam scores within 1e-5 of
the largest term magnitude of the row's leaves (a leaf log-prob is a
sum of terms up to ~100x larger than itself, which cancel, so float32
rounding in another summation order scales with the terms, not the
score) and leaves equal by tie group at that tolerance
(``torch_parity.assert_equal_by_tie_group``); a bf16 pack's scores
within 1e-3 of the terms; sentence ids from the same leaves exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.core import index as jindex
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.core.tree import CobwebTree as JTree
from rag_cobweb_tpu.parallel.vforest import VForest as JForest
from rag_cobweb_tpu_torch import interop
from rag_cobweb_tpu_torch.core import index as tindex
from rag_cobweb_tpu_torch.core import tree as tree_mod

from torch_parity import assert_equal_by_tie_group

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)

NEG = -3e38
K_LANES = 4


def clustered(n, D, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=2.0, size=(6, D))
    return (centers[rng.integers(0, 6, n)]
            + 0.5 * rng.normal(size=(n, D))).astype(np.float32)


@pytest.fixture(scope="module", params=["tree", "forest"])
def case(request):
    """(JAX PredictionIndex, the port's own index over the carried state,
    the JAX index carried across, queries, lane count)."""
    D = 8
    xs = clustered(200, D, seed=4)
    if request.param == "tree":
        jt = JTree(JCfg(dim=D), capacity=4 * len(xs) + 16, seed=0)
        leaves = jt.fit(xs, batch_size=32)
        st = jt._host_arrays()
        tt = interop.tree_from_numpy(
            {f: np.asarray(getattr(st, f)) for f in tree_mod.FIELDS},
            jt.cfg.to_json_dict(), device="cpu")
        jidx = jindex.build_index(jt, leaves)
        own = tindex.build_index(tt, leaves)
        lanes = 1
    else:
        jf = JForest(JCfg(dim=D), n_subtrees=K_LANES, capacity_per_tree=128,
                     seed=0)
        jf.add(xs[:120])
        jf.add(xs[120:])
        st = jax.device_get(jf.state)
        tf = interop.forest_from_numpy(
            {k: np.asarray(v) for k, v in st._asdict().items()},
            {"cfg": jf.cfg.to_json_dict(), "shard_of": jf.shard_of,
             "local_sid": jf.local_sid, "leaf_of_local": jf._leaf_of_local},
            device="cpu")
        jidx = jf.flat_index()
        own = tf.flat_index()
        lanes = K_LANES
    carried = interop.prediction_index_from_numpy(
        {k: np.asarray(v) for k, v in jax.device_get(jidx)._asdict().items()},
        device="cpu")
    return jidx, own, carried, xs[::7] + 0.05, lanes


def depth(jidx) -> int:
    """The beam's scan depth: the longest path, rounded up to 4."""
    return -(-int((np.asarray(jidx.paths) >= 0).sum(1).max()) // 4) * 4


def score_terms(index, q, nodes):
    """The magnitude of a node score's terms, |q| . |mu/var| + 0.5 q^2 .
    1/var + |const|, for (B, M) ``nodes`` (-1: 0): the scale of float32
    rounding in a score whose terms cancel."""
    safe = np.maximum(nodes, 0)
    mov = index.mu_over_var_T.numpy().T[safe]
    iv = index.inv_var_T.numpy().T[safe]
    t = (np.einsum("bd,bmd->bm", np.abs(q), np.abs(mov))
         + 0.5 * np.einsum("bd,bmd->bm", q * q, iv)
         + np.abs(index.const.numpy()[safe]))
    return np.where(nodes >= 0, t, 0.0)


def assert_leaves_match(want, got, index, q, rtol=1e-5):
    """(scores, leaves) of both packages: the same live slots, scores
    within ``rtol`` of the largest term magnitude (``score_terms``) of the
    row's live leaves, leaves equal by tie group at that tolerance over
    each row's live prefix."""
    ws, wn = (np.asarray(a) for a in want)
    gs, gn = (a.numpy() for a in got)
    assert gs.shape == ws.shape
    live = ws > NEG / 2
    np.testing.assert_array_equal(gs > NEG / 2, live)
    np.testing.assert_array_equal(gn[~live], -1)
    terms = score_terms(index, q, np.where(live, wn, -1))
    for b in range(len(ws)):
        m = live[b]
        if m.any():
            tol = rtol * float(terms[b].max())
            scale = max(float(np.abs(ws[b][m]).max()), 1.0)
            assert_equal_by_tie_group([wn[b][m]], [gn[b][m]], [ws[b][m]],
                                      [gs[b][m]], rtol=tol / scale)


def test_build_beam_index_matches_jax(case):
    """The port's own flat index gives the JAX beam structure exactly (a
    node's children are one run of consecutive compact ids; a forest's
    lane roots are rows [0, K)); the pack and const of the carried index
    within 1e-6 relative; a forced bf16 pack rounds alike."""
    jidx, own, carried, _, lanes = case
    want = jindex.build_beam_index(jidx)
    got = tindex.build_beam_index(own)
    for f in ("child_start", "child_count", "leaf_sentence_start",
              "leaf_sentence_count", "sentence_order"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.pack.dtype == torch.float32
    np.testing.assert_array_equal(own.children[:lanes].numpy() >= 0,
                                  np.asarray(jidx.children)[:lanes] >= 0)
    same = tindex.build_beam_index(carried)
    np.testing.assert_allclose(same.pack.numpy(), np.asarray(want.pack),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(same.const.numpy(), np.asarray(want.const),
                               rtol=1e-6, atol=0)
    wb = jindex.build_beam_index(jidx, pack_dtype=jnp.bfloat16)
    gb = tindex.build_beam_index(carried, pack_dtype=torch.bfloat16)
    assert gb.pack.dtype == torch.bfloat16
    np.testing.assert_array_equal(gb.pack.float().numpy(),
                                  np.asarray(wb.pack, np.float32))


@pytest.mark.parametrize("W,k", [(4, 3), (16, 10)])
def test_beam_search_topk_matches_jax(case, W, k):
    """The oracle: leaves by tie group, scores within 1e-5 of their
    terms."""
    jidx, _, carried, q, _ = case
    md = depth(jidx)
    want = jindex.beam_search_topk(jidx, jnp.asarray(q), k, beam_width=W,
                                   max_depth=md)
    got = tindex.beam_search_topk(carried, torch.as_tensor(q), k,
                                  beam_width=W, max_depth=md)
    assert_leaves_match(want, got, carried, q)


@pytest.mark.parametrize("budget", ["untruncated", "2W"])
def test_beam_pack_topk_matches_jax(case, budget):
    """The packed beam (one beam over every lane root) at a budget that
    holds every child (C = W x F) and at one that cuts runs (C = 2W)."""
    jidx, _, carried, q, lanes = case
    W, k = 6, 10
    C = W * carried.children.shape[1] if budget == "untruncated" else 2 * W
    want = jindex.beam_pack_topk(
        jindex.build_beam_index(jidx), jnp.asarray(q), k, beam_width=W,
        max_depth=depth(jidx), cand_budget=C, n_roots=lanes)
    got = tindex.beam_pack_topk(
        tindex.build_beam_index(carried), torch.as_tensor(q), k,
        beam_width=W, max_depth=depth(jidx), cand_budget=C, n_roots=lanes)
    assert_leaves_match(want, got, carried, q)


@pytest.mark.parametrize("roots", ["every lane", "per query"])
def test_beam_pack_topk_lanes_matches_jax(case, roots):
    """The lane-fair beam over every lane, and over per-query roots (two
    lanes a query, one slot of the first query -1)."""
    jidx, _, carried, q, lanes = case
    k, Wl = 10, 4
    r, n = None, lanes
    if roots == "per query":
        rng = np.random.default_rng(1)
        n = min(2, lanes)
        r = np.stack([rng.permutation(lanes)[:n] for _ in range(len(q))]
                     ).astype(np.int32)
        r[0, -1] = -1
    want = jindex.beam_pack_topk_lanes(
        jindex.build_beam_index(jidx), jnp.asarray(q), k, lane_width=Wl,
        max_depth=depth(jidx), n_lanes=n,
        roots=None if r is None else jnp.asarray(r))
    got = tindex.beam_pack_topk_lanes(
        tindex.build_beam_index(carried), torch.as_tensor(q), k,
        lane_width=Wl, max_depth=depth(jidx), n_lanes=n,
        roots=None if r is None else torch.as_tensor(r))
    assert_leaves_match(want, got, carried, q)


@pytest.mark.parametrize("k", [1, 10, 60])
def test_leaf_runs_and_sentence_ids_match_jax(case, k):
    """From the same ranked leaves: ``leaf_runs_to_sids`` (device) and
    ``leaves_to_sentence_ids`` (host) give the JAX package's ids
    exactly; ``beam_query_ids`` gives its ids."""
    jidx, _, carried, q, lanes = case
    jb, tb = jindex.build_beam_index(jidx), tindex.build_beam_index(carried)
    ws, wn = jindex.beam_pack_topk(jb, jnp.asarray(q), k, beam_width=8,
                                   max_depth=depth(jidx), n_roots=lanes)
    want = np.asarray(jindex.leaf_runs_to_sids(
        jb.leaf_sentence_start, jb.leaf_sentence_count, jb.sentence_order,
        wn, ws, k))
    got = tindex.leaf_runs_to_sids(
        tb.leaf_sentence_start, tb.leaf_sentence_count, tb.sentence_order,
        torch.as_tensor(np.array(wn), dtype=torch.int64),
        torch.as_tensor(np.array(ws)), k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tindex.leaves_to_sentence_ids(carried, np.asarray(wn), k),
        jindex.leaves_to_sentence_ids(jidx, np.asarray(wn), k))
    np.testing.assert_array_equal(
        tindex.beam_query_ids(tb, torch.as_tensor(q), k, beam_width=8,
                              max_depth=depth(jidx), n_roots=lanes).numpy(),
        np.asarray(jindex.beam_query_ids(jb, q, k, beam_width=8,
                                         max_depth=depth(jidx),
                                         n_roots=lanes)))


def test_bf16_pack_matches_jax(case):
    """A forced bf16 pack (the form from 2^19 nodes): bf16 products
    accumulated in f32, scores within 1e-3 of their terms, leaves by tie
    group, in both beams."""
    jidx, _, carried, q, lanes = case
    jb = jindex.build_beam_index(jidx, pack_dtype=jnp.bfloat16)
    tb = tindex.build_beam_index(carried, pack_dtype=torch.bfloat16)
    md = depth(jidx)
    want = jindex.beam_pack_topk(jb, jnp.asarray(q), 10, beam_width=6,
                                 max_depth=md, n_roots=lanes)
    got = tindex.beam_pack_topk(tb, torch.as_tensor(q), 10, beam_width=6,
                                max_depth=md, n_roots=lanes)
    assert_leaves_match(want, got, carried, q, rtol=1e-3)
    want = jindex.beam_pack_topk_lanes(jb, jnp.asarray(q), 10, lane_width=4,
                                       max_depth=md, n_lanes=lanes)
    got = tindex.beam_pack_topk_lanes(tb, torch.as_tensor(q), 10,
                                      lane_width=4, max_depth=md,
                                      n_lanes=lanes)
    assert_leaves_match(want, got, carried, q, rtol=1e-3)
