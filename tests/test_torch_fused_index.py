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
