"""Within-tree tensor parallelism of the port (``parallel/tp.py``) on 2 and
4 gloo ranks against the JAX package's on the same-sized virtual CPU mesh
(``make_mesh(n)``), both engines on the same index: the JAX tree's
PredictionIndex and its FusedIndex (f32 and bf16), carried across.

Tolerances are the JAX tests' own (``tests/test_tp.py``): scores within
``rtol=1e-4, atol=1e-3`` of the JAX engine's (partial products summed in
another order) and equal id sets; with stored rows, the merged ordering
equal to the single-device exact re-rank's, for both engines and both
dtypes.  D = 21 is not a multiple of 2 or 4 (the D padding) and S = 210
not a multiple of 4 (the S padding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from rag_cobweb_tpu.core import index as jindex
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.core.tree import CobwebTree as JTree
from rag_cobweb_tpu.parallel.forest import make_mesh
from rag_cobweb_tpu.parallel.tp import (TPFusedPredictionIndex as JFused,
                                        TPPredictionIndex as JTP)
from rag_cobweb_tpu_torch.bench import multichip

torch.set_num_threads(1)
D = 21


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=3.0, size=(10, D))
    xs = np.concatenate(
        [c + 0.2 * rng.normal(size=(21, D)) for c in centers]
    ).astype(np.float32)
    xs = xs[rng.permutation(len(xs))]
    tree = JTree(JCfg(dim=D), capacity=2048, seed=0)
    leaves = tree.fit(xs)
    idx = jindex.build_index(tree, leaves)
    fused = {"f32": jindex.build_fused_index(idx),
             "bf16": jindex.build_fused_index(idx, dtype=jnp.bfloat16)}
    return idx, fused, xs


def exact_order(xs, q, k=5):
    d2 = ((q[:, None, :] - xs[None, :, :]) ** 2).sum(-1)
    return np.argsort(d2, axis=1, kind="stable")[:, :k]


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def run(request, built):
    n = request.param
    idx, fused, xs = built
    host = {k: np.asarray(v) for k, v in idx._asdict().items()}
    payload = {
        "index": host, "xs": xs, "q": xs[:32], "q2": xs[:16] + 0.01,
        "fused": {dt: (np.asarray(f.GT).astype(np.float32),
                       np.asarray(f.c), np.asarray(f.valid))
                  for dt, f in fused.items()}}
    out = multichip.spawn(torch_ranks.tp_rank, n, payload, device="cpu",
                          timeout=300, threads=1)
    return n, payload, out


def same_on_every_rank(out, key):
    s0, i0 = out[0][key]
    for o in out[1:]:
        np.testing.assert_array_equal(o[key][0], s0)
        np.testing.assert_array_equal(o[key][1], i0)
    return s0, i0


def test_shards_cover_d_and_s(run, built):
    n, _, out = run
    idx, _, xs = built
    Dp, Sp = -(-D // n) * n, -(-len(xs) // n) * n
    assert Dp != D or n == 1
    ivt, movt, const, paths, pw, sid, leaf, emb = out[0]["local_shapes"]
    N = idx.inv_var_T.shape[1]
    assert ivt == movt == (Dp // n, N) and const == (N,)
    assert sid == leaf == (Sp // n,) and emb == (Sp // n, 0)


def test_tp_query_matches_jax(run, built):
    n, p, out = run
    idx, _, _ = built
    want_s, want_i = JTP(idx, make_mesh(n)).query_topk(p["q"], 5)
    got_s, got_i = same_on_every_rank(out, "path")
    np.testing.assert_allclose(np.sort(got_s, 1), np.sort(want_s, 1),
                               rtol=1e-4, atol=1e-3)
    for b in range(len(got_i)):
        assert set(got_i[b]) == set(want_i[b]), b


def test_tp_leaf_rerank_matches_jax(run, built):
    """The re-rank by leaf log-prob without stored rows: the keys of the
    JAX engine, each query finding itself."""
    n, p, out = run
    idx, _, _ = built
    want_s, _ = JTP(idx, make_mesh(n)).query_topk(p["q"], 5, rerank=32)
    got_s, got_i = same_on_every_rank(out, "path_leaf")
    np.testing.assert_allclose(got_s, want_s, rtol=1e-4, atol=1e-3)
    assert all(b in got_i[b] for b in range(len(got_i)))


def test_tp_exact_rerank_ordering(run, built):
    n, p, out = run
    idx, _, xs = built
    _, got = same_on_every_rank(out, "path_exact")
    np.testing.assert_array_equal(got, exact_order(xs, p["q2"]))
    _, want = JTP(idx, make_mesh(n), embeddings=xs).query_topk(
        p["q2"], 5, rerank=64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_tp_fused_query_matches_jax(run, built, dt):
    n, p, out = run
    _, fused, _ = built
    want_s, want_i = JFused(fused[dt], make_mesh(n)).query_topk(p["q"], 5)
    got_s, got_i = same_on_every_rank(out, f"fused_{dt}")
    np.testing.assert_allclose(got_s, want_s, rtol=1e-4, atol=1e-3)
    for b in range(len(got_i)):
        assert set(got_i[b]) == set(want_i[b]), b


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_tp_fused_exact_rerank_ordering(run, built, dt):
    """Pool from the slab sweep, exact stored-row L2 as the merge key:
    the merged ordering is the single-device exact re-rank's, and the
    scores are ``-||q - x||^2``."""
    n, p, out = run
    _, fused, xs = built
    got_s, got = same_on_every_rank(out, f"fused_exact_{dt}")
    np.testing.assert_array_equal(got, exact_order(xs, p["q2"]))
    want_s, want = JFused(fused[dt], make_mesh(n), embeddings=xs
                          ).query_topk(p["q2"], 5, rerank=64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-6)
