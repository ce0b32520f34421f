"""Fused build and sweep of the PyTorch port against the JAX package.

A JAX VForest state is copied into the port through ``interop``; from the
same state both packages build the fused index.  Tolerances: GT and c
within rtol=1e-5 in float32 (only float32 summation order differs; c gets
atol=1e-4 as in tests/test_fused_state.py since it sums large
log-variance terms); bf16 GT within one bf16 rounding (rtol=2^-7).  Top-k
id SETS must be equal wherever the reference path is exact: the f32 XLA
top-k and the Pallas fused kernel in interpret mode with block_k >= k."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.core import index as jidx
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.parallel.vforest import VForest as JForest
from rag_cobweb_tpu_torch import interop
from rag_cobweb_tpu_torch.core import index as tidx
from rag_cobweb_tpu_torch.core import tree as tree_mod
from rag_cobweb_tpu_torch.ops import fused_topk

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
    import jax
    st = jax.device_get(jf.state)
    meta = {"cfg": jf.cfg.to_json_dict(), "shard_of": jf.shard_of,
            "local_sid": jf.local_sid, "leaf_of_local": jf._leaf_of_local}
    tf = interop.forest_from_numpy(
        {k: np.asarray(v) for k, v in st._asdict().items()}, meta,
        device="cpu")
    return jf, tf, xs


def test_interop_copies_the_forest(forests):
    jf, tf, _ = forests
    np.testing.assert_array_equal(tf._leaf_global(), jf._leaf_global())
    got = tree_mod.state_to_numpy(tf.state)
    import jax
    st = jax.device_get(jf.state)
    for f in tree_mod.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(st, f)), got[f])


def test_load_jax_npz(forests, tmp_path):
    jf, tf, _ = forests
    path = str(tmp_path / "forest.npz")
    jf.save_npz(path)
    lf = interop.load_jax_npz(path, device="cpu")
    assert lf.K == jf.K and lf.n_sentences == jf.n_sentences
    np.testing.assert_array_equal(lf._leaf_global(), jf._leaf_global())
    for lane in range(jf.K):
        assert lf.lane_signature(lane) == tf.lane_signature(lane)


def test_fused_build_matches_jax_f32(forests):
    jf, tf, _ = forests
    want = jf.fused_index()
    got = tf.fused_index()
    assert got.GT.shape == tuple(want.GT.shape)
    S = jf.n_sentences
    np.testing.assert_allclose(got.GT.numpy()[:, :S],
                               np.asarray(want.GT)[:, :S],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.c.numpy()[:S], np.asarray(want.c)[:S],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert not got.GT.numpy()[:, S:].any() and not got.c.numpy()[S:].any()


def test_fused_build_matches_jax_bf16(forests):
    jf, tf, _ = forests
    want = jf.fused_index(dtype=jnp.bfloat16)
    got = tf.fused_index(dtype=torch.bfloat16)
    assert got.GT.dtype == torch.bfloat16
    np.testing.assert_allclose(got.GT.float().numpy(),
                               np.asarray(want.GT, np.float32),
                               rtol=2 ** -7, atol=1e-6)


def test_chase_depth_escalates(forests):
    """A chase budget below the deepest chain doubles until every chain
    reaches a root — same coefficients as a generous budget."""
    _, tf, _ = forests
    lg = tf._leaf_global()
    a = tidx.build_fused_from_state(tf.cfg, tf.state, lg, chase_depth=2)
    b = tidx.build_fused_from_state(tf.cfg, tf.state, lg, chase_depth=64)
    np.testing.assert_array_equal(a.GT.numpy(), b.GT.numpy())


def test_fused_scores_match_jax(forests):
    jf, tf, xs = forests
    fj = jf.fused_index()
    ft = interop.fused_index_from_numpy(np.asarray(fj.GT), np.asarray(fj.c),
                                        np.asarray(fj.valid), device="cpu")
    q = xs[:20] + 0.05
    want = np.asarray(jidx.fused_scores(fj, jnp.asarray(q)))
    got = tidx.fused_scores(ft, torch.as_tensor(q)).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(fin, np.isfinite(got))
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("k", [1, 7, 40])
def test_fused_query_topk_matches_jax_exact(forests, k):
    jf, tf, xs = forests
    fj = jf.fused_index()
    ft = interop.fused_index_from_numpy(np.asarray(fj.GT), np.asarray(fj.c),
                                        np.asarray(fj.valid), device="cpu")
    q = xs[::9] + 0.05
    ws, wi = jidx.fused_query_topk(fj, jnp.asarray(q), k, approx=False)
    gs, gi = tidx.fused_query_topk(ft, torch.as_tensor(q), k)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-4)
    for b in range(len(q)):
        assert set(gi[b].tolist()) == set(np.asarray(wi)[b].tolist())


def test_fused_query_topk_matches_pallas_interpret(forests):
    from rag_cobweb_tpu.ops.pallas_query import pallas_fused_topk
    jf, tf, xs = forests
    fj = jf.fused_index()
    ft = interop.fused_index_from_numpy(np.asarray(fj.GT), np.asarray(fj.c),
                                        np.asarray(fj.valid), device="cpu")
    q = xs[:6] + 0.05
    ws, wi = pallas_fused_topk(fj, jnp.asarray(q), 5, interpret=True,
                               block_k=8)
    gs, gi = tidx.fused_query_topk(ft, torch.as_tensor(q), 5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-4,
                               atol=1e-4)
    for b in range(len(q)):
        assert set(gi[b].tolist()) == set(np.asarray(wi)[b].tolist())


def test_f32_slab_topk_matches_pallas_interpret_over_two_slabs():
    """Kernel 1's f32 contract: the port's ``slab_topk`` (on the host, its
    plain version) at kappa 10 over two slabs against the JAX
    ``pallas_fused_topk`` in interpret mode on an f32 FusedIndex
    (``Precision.HIGHEST``, block_k 10, all 20 candidates kept).  Scores
    take few values, each exact in any summation order, so many tie at
    each slab's 10th; invalid rows (the second slab's last 548) carry a
    bias that would win were they not masked.  Per query and slab: ids
    equal, in (score, id) order, scores within 1e-5."""
    from rag_cobweb_tpu.ops.pallas_query import pallas_fused_topk
    rng = np.random.default_rng(9)
    B, D, Sp, kappa = 7, 4, 4096, 10
    q = rng.integers(-2, 3, size=(B, D)).astype(np.float32) / 2
    GT = rng.integers(-2, 3, size=(2 * D, Sp)).astype(np.float32) / 4
    c = rng.integers(-1, 2, size=Sp).astype(np.float32)
    valid = np.arange(Sp) < 2048 + 1500
    c[~valid] = 1000.0
    fj = jidx.FusedIndex(GT=jnp.asarray(GT), c=jnp.asarray(c),
                         valid=jnp.asarray(valid))
    ws, wi = pallas_fused_topk(fj, jnp.asarray(q), 2 * kappa,
                               interpret=True, block_k=kappa)
    ws, wi = np.asarray(ws), np.asarray(wi)
    ps, pi = fused_topk.slab_topk(
        fused_topk.query_terms(torch.as_tensor(q), torch.float32),
        torch.as_tensor(GT), torch.as_tensor(c), torch.as_tensor(valid),
        kappa)
    full = np.where(valid, np.concatenate([q, q * q], 1) @ GT + c, -np.inf)
    straddles = 0
    for b in range(B):
        for sl in range(2):
            mine = wi[b] // 2048 == sl
            order = sorted(zip(-ws[b][mine], wi[b][mine]))
            np.testing.assert_array_equal(
                pi[sl, b].numpy(), [i for _, i in order])
            np.testing.assert_allclose(ps[sl, b].numpy(),
                                       [-s for s, _ in order], rtol=0,
                                       atol=1e-5)
            seg = full[b, sl * 2048:(sl + 1) * 2048]
            straddles += int((seg == ps[sl, b, -1].item()).sum()
                             > (ps[sl, b] == ps[sl, b, -1]).sum().item())
    assert straddles >= B        # ties cut at the 10th in most pools


@pytest.mark.parametrize("kappa", [1, 5, 2048])
def test_slab_topk_plain_is_exact_per_slab(kappa):
    """The kernel's plain version: per 2048-row slab, the top-kappa by
    (score desc, id asc), padding rows -inf — checked against numpy."""
    rng = np.random.default_rng(kappa)
    B, twoD, Sp, S = 5, 6, 4096, 3000
    qq = rng.normal(size=(B, twoD)).astype(np.float32)
    GT = rng.normal(size=(twoD, Sp)).astype(np.float32)
    GT[:, 7] = GT[:, 3]            # an exact tie: the lower id goes first
    c = rng.normal(size=(Sp,)).astype(np.float32)
    c[7] = c[3]
    valid = np.arange(Sp) < S
    s, i = fused_topk.slab_topk(torch.as_tensor(qq), torch.as_tensor(GT),
                                torch.as_tensor(c), torch.as_tensor(valid),
                                kappa)
    assert s.shape == (2, B, kappa) and i.dtype == torch.int32
    full = np.where(valid, qq.astype(np.float64) @ GT + c, -np.inf)
    for sl in range(2):
        for b in range(B):
            seg = full[b, sl * 2048:(sl + 1) * 2048]
            order = sorted(range(2048), key=lambda j: (-seg[j], j))[:kappa]
            np.testing.assert_array_equal(i[sl, b].numpy(),
                                          np.asarray(order) + sl * 2048)


def test_slab_topk_rejects_bad_inputs():
    qq = torch.zeros((2, 4))
    GT = torch.zeros((4, 2048))
    c = torch.zeros((2048,))
    valid = torch.ones((2048,), dtype=torch.bool)
    with pytest.raises(ValueError):
        fused_topk.slab_topk(qq, torch.zeros((4, 1000)), c[:1000],
                             valid[:1000], 4)
    with pytest.raises(ValueError):
        fused_topk.slab_topk(qq, GT, c, valid, 0)
    with pytest.raises(TypeError):
        fused_topk.slab_topk(qq.double(), GT.double(), c, valid, 4)
    with pytest.raises(ValueError):
        fused_topk.slab_topk(qq, GT, c, valid.float(), 4)


def _pool_inputs(B, twoD, Sp, S, seed, dup=0, dead=(), flat=()):
    """Sweep inputs of few values, exact in float32 in any order, so many
    scores tie exactly; ``dup``: runs of ``dup`` equal rows (inside one
    64-row group); ``dead``: slabs with no valid row; ``flat``: queries of
    zeros, whose scores are c alone (a third of the rows tie at the top)."""
    rng = np.random.default_rng(seed)
    qq = rng.integers(-2, 3, size=(B, twoD)).astype(np.float32) / 2
    qq[list(flat)] = 0
    GT = rng.integers(-2, 3, size=(twoD, Sp)).astype(np.float32) / 4
    c = rng.integers(-1, 2, size=Sp).astype(np.float32)
    if dup:
        rows = np.arange(Sp) // dup * dup
        GT, c = GT[:, rows], c[rows]
    valid = np.arange(Sp) < S
    for sl in dead:
        valid[sl * 2048:(sl + 1) * 2048] = False
    return tuple(torch.as_tensor(a) for a in (qq, GT, c, valid))


def _stable_top(qq, GT, c, valid, k):
    """The top k of the plain scores by (score desc, id asc), in numpy."""
    s = fused_topk.slab_scores_plain(qq, GT, c, valid, float("-inf"))
    s = s.reshape(len(qq), -1).numpy()
    ids = np.broadcast_to(np.arange(s.shape[1]), s.shape)
    order = np.lexsort((ids, -s), axis=1)[:, :k]
    return np.take_along_axis(s, order, 1), order


# (B, 2D, Sp, live rows, k, survivors' buffer, equal-row runs, dead slabs,
# flat queries)
_PRUNED = {
    "ties_at_the_kth": (5, 6, 8192, 8192, 100, 512, 0, (), ()),
    "equal_rows_in_a_group": (4, 6, 8192, 8192, 64, 1024, 16, (), ()),
    "dead_slab": (3, 6, 8192, 8192, 50, 256, 0, (1,), ()),
    "fewer_live_rows_than_k": (3, 6, 8192, 40, 100, 512, 0, (), ()),
    "k_above_the_groups": (2, 6, 4096, 4096, 300, 4096, 0, (), ()),
    "k_2048": (2, 6, 8192, 8192, 2048, 8192, 0, (), ()),
    "live_rows_end_inside_a_group": (4, 6, 8192, 8010, 100, 512, 0, (), ()),
    "overflow": (4, 6, 8192, 8192, 100, 128, 8, (), ()),
    "overflow_of_some_queries": (6, 6, 8192, 8192, 100, 512, 0, (),
                                 (1, 4)),
}


@pytest.mark.parametrize("case", list(_PRUNED))
def test_pruned_pool_plain_matches_the_per_slab_pools(case, monkeypatch):
    """The pruned path's plain version against the per-slab pools
    (``slab_topk_plain``) merged: the same score multiset, and the same ids
    with ties to the lower id; every query keeps at least min(k, live rows)
    survivors; dead slots are -inf with id -1.  Through ``pool_sweep`` and
    ``pool_select``, the queries past the buffer (``overflow``: all of
    them, ``overflow_of_some_queries``: two) are answered by their per-slab
    pools, one query a chunk, exactly, and counted on ``pool.overflow``."""
    from rag_cobweb_tpu_torch.utils import profiling
    B, twoD, Sp, S, k, cap, dup, dead, flat = _PRUNED[case]
    qq, GT, c, valid = _pool_inputs(B, twoD, Sp, S, len(case), dup, dead,
                                    flat)
    p = fused_topk.pruned_sweep(qq, GT, c, valid, k, cap)
    (ts, ti), over = fused_topk.pruned_select(p)
    live = int(valid.sum())
    assert bool((p.survivors >= min(k, live)).all())
    assert int(over) == int((p.survivors > cap).sum())
    assert int(over) == {"overflow": B,
                         "overflow_of_some_queries": len(flat)}.get(case, 0)
    ms, _ = fused_topk.merge(*fused_topk.slab_topk_plain(
        qq, GT, c, valid, min(k, 2048)), k)
    assert torch.equal(ts, ms)                    # the same multiset, sorted
    # the entry itself: these shapes take the per-slab pools
    assert not fused_topk.use_pruned(B, Sp // 2048, k, twoD, 4)
    assert torch.equal(fused_topk.pool_select(fused_topk.pool_sweep(
        qq, GT, c, valid, k))[0], ms)
    rs, ri = _stable_top(qq, GT, c, valid, k)
    fin = np.isfinite(rs)
    np.testing.assert_array_equal(ts.numpy(), rs)
    np.testing.assert_array_equal(ti.numpy()[fin], ri[fin])
    assert bool((ti[~torch.as_tensor(fin)] == -1).all())
    monkeypatch.setattr(fused_topk, "FALLBACK_BYTES", 1)
    n0 = profiling.counter("pool.overflow")
    es, ei = fused_topk.pool_select(fused_topk.pool_sweep(
        qq, GT, c, valid, k, pruned=True, cap=cap))
    assert profiling.counter("pool.overflow") - n0 == int(over)
    np.testing.assert_array_equal(es.numpy(), rs)
    np.testing.assert_array_equal(ei.numpy()[fin], ri[fin])


# (B, NS, k, 2D, element bytes) of the cells' pools and around them
_SHAPES = {
    "batch_sweep": ((1024, 512, 512, 256, 2), True),
    "batch_backstop": ((1024, 605, 512, 128, 2), True),
    "mixed_sweep_b32": ((32, 256, 1024, 1334, 2), False),
    "mixed_backstop_b32": ((32, 256, 1024, 667, 2), False),
    "mixed_backstop_b64": ((64, 256, 1024, 667, 2), False),
    "batch_sweep_b1": ((1, 512, 512, 256, 2), False),
    "f32_operands": ((1024, 512, 512, 256, 4), False),
    "few_slabs": ((1024, 5, 512, 256, 2), False),
    "widest_resident": ((1024, 512, 512, 320, 2), True),
}


@pytest.mark.parametrize("shape", list(_SHAPES))
def test_pool_topk_dispatch_on_the_cells_shapes(shape):
    """The dispatch rule on the shapes alone: the batch cell's two pools
    take the pruned path, the mixed cell's (B=32, and 2D = 667 and 1334,
    wider than the passes hold at any B) and B=1 and f32 operands and a few
    slabs do not; the chunk's bytes (``pool_bytes``) are the dispatched
    path's: the pruned path's group keys and survivors, or the per-slab
    pools."""
    (B, NS, k, two_d, elt), want = _SHAPES[shape]
    assert fused_topk.use_pruned(B, NS, k, two_d, elt) is want
    kk = min(k, NS * fused_topk.SLAB)
    cap = fused_topk.prune_cap(kk)
    per_slab = NS * min(k, fused_topk.SLAB) * 8
    pruned = NS * 32 * 4 + cap * 8 + kk * 8
    assert fused_topk.pool_bytes(B, NS, k, two_d, elt) == (
        pruned if want else per_slab)
    assert cap >= 4 * kk and cap & (cap - 1) == 0
