"""The memory tools of a large index, port against the JAX package:
stats compression (``compress_stats``), the state offload
(``offload_state``), the move of a build between devices (``to_device``,
``build_device``/``promote_build_device``) and the bf16 re-rank store
(``emb_store_dtype``, kernel 5's bf16 entry through its plain version).

Data: ``tests/test_compress.py``'s, ``synthetic_retrieval(2048, 128, 64,
seed=3)`` into 4 lanes, built by both packages from the same rows (the
two builds place every row alike).

Tolerances:
- compressed stats: within one bf16 ulp of the JAX package's (each
  package rounds its own f32 statistics once);
- the fused index rebuilt from compressed stats: the port's within 1e-5 of
  its terms of the JAX package's (f32 sums in another order of the same
  upcast values), and within 2^-7 of its terms of the f32 state's index
  (one bf16 rounding of the statistics);
- served ids: equal wherever the re-rank key ties no other key of the
  row (``torch_parity.assert_equal_by_tie_group``, keys rtol 1e-5);
- the JAX test's own bounds: recall@10 within 0.01 and top-10 overlap
  at least 0.9 after compression, recall within 0.02 with the bf16 store;
- bf16-store keys: within 1e-5 of the terms of the JAX ``exact_rerank``
  keys over the same bf16 rows (f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.bench.datasets import synthetic_retrieval
from rag_cobweb_tpu.bench.metrics import retrieval_metrics
from rag_cobweb_tpu.core import index as jidx
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.core.wrapper import CobwebIndex as JIndex
from rag_cobweb_tpu_torch.core import index as tidx
from rag_cobweb_tpu_torch.core import tree as tree_mod
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
from rag_cobweb_tpu_torch.parallel.vforest import VForest
from torch_parity import assert_equal_by_tie_group

torch.set_num_threads(2)

N, K = 2048, 4


def _recall(ids, data, k=10):
    return retrieval_metrics(np.asarray(ids), data.target_ids,
                             k)[f"recall@{k}"]


def _overlap(a, b):
    return float(np.mean([len(set(x) & set(y)) / len(x)
                          for x, y in zip(np.asarray(a).tolist(),
                                          np.asarray(b).tolist())]))


def _keys(corpus, queries, ids):
    """The re-rank key's order, -||q - x||^2 in float64, of each id."""
    x = np.asarray(corpus, np.float64)[np.asarray(ids)]
    return -np.sum(np.square(np.asarray(queries, np.float64)[:, None] - x),
                   axis=-1)


def _hold_ids(corpus, queries, want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert_equal_by_tie_group(want, got, _keys(corpus, queries, want),
                              _keys(corpus, queries, got))


def _bits(a) -> np.ndarray:
    """bf16 values as their 16 bits (int32, for ulp differences)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().astype(np.int32) & 0xFFFF
    return np.asarray(a).view(np.uint16).astype(np.int32)


@pytest.fixture(scope="module")
def built():
    """Both packages' 4-lane forests over the same rows, with their f32
    ids served before any tool (the small-forest engine, pool 256)."""
    data = synthetic_retrieval(N, 128, 64, seed=3)
    jdb = JIndex(config=JCfg(dim=64), capacity=4 * N + 16, n_subtrees=K,
                 seed=0)
    tdb = CobwebIndex(config=TreeConfig(dim=64), capacity=4 * N + 16,
                      n_subtrees=K, seed=0, device="cpu")
    for db in (jdb, tdb):
        db.add_sentences([None] * N, data.corpus_embs)
    f32 = {
        "jax": np.asarray(jdb.query_ids(data.query_embs, 10, rerank=256)),
        "port": tdb.query_ids(data.query_embs, 10, rerank=256).numpy(),
        "jax_fused": jdb.forest.fused_index(),
        "port_fused": tdb.forest.fused_index(),
    }
    return jdb, tdb, data, f32


@pytest.fixture(scope="module")
def compressed(built):
    jdb, tdb, data, f32 = built
    for db in (jdb, tdb):
        db.compress_stats()
    return built


def test_f32_builds_serve_equal_ids(built):
    jdb, tdb, data, f32 = built
    np.testing.assert_array_equal(tdb.forest._leaf_global(),
                                  jdb.forest._leaf_global())
    _hold_ids(data.corpus_embs, data.query_embs, f32["jax"], f32["port"])


def test_compressed_stats_within_one_bf16_ulp(compressed):
    jdb, tdb, _, _ = compressed
    st = tdb.forest.state
    assert st.means.dtype == st.m2s.dtype == torch.bfloat16
    assert st.counts.dtype == torch.float32
    jst = jax.device_get(jdb.forest.state)
    cap = st.capacity
    for name in ("means", "m2s"):
        got = _bits(getattr(st, name)[:, :cap])
        want = _bits(getattr(jst, name))
        assert np.abs(got - want).max() <= 1, name
    # applied once: a second call changes nothing
    means = st.means
    tdb.forest.compress_stats()
    assert tdb.forest.state.means is means


def test_fused_index_from_compressed_stats(compressed):
    """The stats-free fused build reads the compressed stats upcast: the
    port's f32 GT equals the JAX package's from its compressed state, and
    both stay within a bf16 rounding of the f32 state's index."""
    jdb, tdb, _, f32 = compressed
    got = tdb.forest.fused_index()
    want = jdb.forest.fused_index()
    gt, c = got.GT.numpy(), got.c.numpy()
    jgt, jc = np.asarray(want.GT), np.asarray(want.c)
    scale = np.abs(jgt).max(axis=0, keepdims=True) + 1.0
    assert np.abs(gt - jgt).max() <= 1e-5 * scale.max()
    np.testing.assert_allclose(c, jc, rtol=1e-5, atol=1e-5 * np.abs(jc).max())
    old = f32["port_fused"].GT.numpy()
    assert np.all(np.abs(gt - old) <= 2.0 ** -7 * (np.abs(old) + scale))
    assert not np.array_equal(gt, old)      # the rounding shows


@pytest.mark.parametrize("engine", ["small_forest", "fused"])
def test_compressed_serving_equals_jax(compressed, engine):
    """Served ids after compression equal the JAX package's by tie group,
    on the small-forest engine (2048 rows) and on the fused engine (with
    ``blocked_threshold`` lowered below the corpus)."""
    jdb, tdb, data, _ = compressed
    if engine == "fused":
        for db in (jdb, tdb):
            db.blocked_threshold = 1024
    try:
        want = np.asarray(jdb.query_ids(data.query_embs, 10, rerank=256))
        got = tdb.query_ids(data.query_embs, 10, rerank=256).numpy()
    finally:
        for db in (jdb, tdb):
            db.blocked_threshold = 8192
    _hold_ids(data.corpus_embs, data.query_embs, want, got)


def test_compression_keeps_the_jax_tests_bounds(compressed):
    jdb, tdb, data, f32 = compressed
    got = tdb.query_ids(data.query_embs, 10, rerank=256).numpy()
    assert _recall(got, data) >= _recall(f32["port"], data) - 0.01
    assert _overlap(f32["port"], got) >= 0.9


def test_add_into_compressed_forest(compressed):
    """64 rows added into the compressed state in both packages: every
    leaf placed, the new stats rounded into bf16 within one ulp of the
    JAX package's, and each row found as itself."""
    jdb, tdb, data, _ = compressed
    extra = (data.corpus_embs[:64] + 0.05).astype(np.float32)
    n0 = len(tdb)
    want = np.asarray(jdb.add_sentences([None] * 64, extra))
    got = np.asarray(tdb.add_sentences([None] * 64, extra))
    np.testing.assert_array_equal(got, want)
    st, jst = tdb.forest.state, jax.device_get(jdb.forest.state)
    assert st.means.dtype == torch.bfloat16
    cap = st.capacity
    assert np.abs(_bits(st.means[:, :cap]) - _bits(jst.means)).max() <= 1
    ids = tdb.query_ids(extra[:8], 5).numpy()
    assert (ids[:, 0] == np.arange(n0, n0 + 8)).all()
    _hold_ids(np.concatenate([data.corpus_embs, extra]), extra[:8],
              np.asarray(jdb.query_ids(extra[:8], 5)), ids)


def test_offload_state_serves_and_readds(compressed, monkeypatch):
    """``offload_state`` once the serving index exists: serving reads no
    state (no ``_resident`` call) and gives the same ids; the next add
    brings the state back first and inserts as the JAX package does."""
    jdb, tdb, data, _ = compressed
    before = tdb.query_ids(data.query_embs, 10, rerank=256).numpy()
    tdb.offload_state()
    jdb.offload_state()
    assert tdb.forest.state.device.type == "cpu"
    assert tdb.forest._graph is None
    calls = []
    orig = VForest._resident

    def spy(self):
        calls.append(1)
        return orig(self)

    monkeypatch.setattr(VForest, "_resident", spy)
    after = tdb.query_ids(data.query_embs, 10, rerank=256).numpy()
    assert not calls
    np.testing.assert_array_equal(after, before)
    rows = data.corpus_embs[:8]
    got = tdb.add_sentences([None] * 8, rows)
    assert calls
    np.testing.assert_array_equal(
        got, np.asarray(jdb.add_sentences([None] * 8, rows)))
    assert tdb.forest.state.means.dtype == torch.bfloat16


def test_bf16_store_keys_match_jax_exact_rerank(compressed):
    """``emb_store_dtype = "bfloat16"``: the next query rebuilds the store
    in bf16; kernel 5's keys (its plain version here) over it equal the
    JAX ``exact_rerank`` over the same bf16 rows within 1e-5 of the
    terms; recall within the JAX test's 0.02 of the f32 store's."""
    jdb, tdb, data, _ = compressed
    r_f32 = _recall(tdb.query_ids(data.query_embs, 10, rerank=256).numpy(),
                    data)
    f32_rows = tdb._emb_device()[:len(tdb)].clone()
    tdb.emb_store_dtype = "bfloat16"
    emb = tdb._emb_device()
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(emb[:len(tdb)].float().numpy(),
                                  f32_rows.to(torch.bfloat16).float()
                                  .numpy())
    got = tdb.query_ids(data.query_embs, 10, rerank=256).numpy()
    assert _recall(got, data) >= r_f32 - 0.02
    rng = np.random.default_rng(0)
    q = data.query_embs[:32]
    cand = rng.integers(0, len(tdb), (32, 96)).astype(np.int32)
    cand[:, 1] = cand[:, 0]                        # a duplicate id
    cs = rng.normal(size=cand.shape).astype(np.float32)
    cs[:, -5:] = -np.inf
    pv = float(tdb.cfg.prior_var)
    ks, ki = tidx.exact_rerank(emb, torch.as_tensor(q), torch.as_tensor(cand),
                               torch.as_tensor(cs), 10, pv)
    js, ji = jidx.exact_rerank(
        jnp.asarray(f32_rows.numpy(), jnp.bfloat16), jnp.asarray(q),
        jnp.asarray(cand), jnp.asarray(cs), 10, jnp.float32(pv))
    terms = 0.5 * (np.abs(np.asarray(js)) + q.shape[1] * abs(np.log(pv)))
    assert np.all(np.abs(ks.numpy() - np.asarray(js)) <= 1e-5 * terms)
    assert_equal_by_tie_group(np.asarray(ji), ki.numpy(), np.asarray(js),
                              ks.numpy())
    tdb.emb_store_dtype = "float32"


def test_bf16_store_keeps_the_exact_rows(compressed, tmp_path):
    """With a bf16 store the exact rows stay on the host: ``save`` writes
    them, tier 0 keys an added row on them, and going back to float32
    restores the f32 store bit for bit."""
    _, tdb, data, _ = compressed
    n = len(tdb)
    exact = tdb._emb_device()[:n].numpy().copy()
    tdb.emb_store_dtype = "bfloat16"
    assert tdb._emb_device().dtype == torch.bfloat16
    path = str(tmp_path / "bf16_store.npz")
    tdb.save(path)
    with np.load(path, allow_pickle=True) as z:
        np.testing.assert_array_equal(z["vectors"], exact)
    tdb.emb_store_dtype = "float32"
    np.testing.assert_array_equal(tdb._emb_device()[:n].numpy(), exact)
    assert tdb._emb_host is None


def test_bf16_raw_store_without_whitener_serves_jax_ids():
    """No whitener: the backstop keys on the raw re-rank store itself,
    row-major.  Stored in bf16 it must take the row-major product, as the
    JAX package does, not kernel 1's GT route: served ids equal the JAX
    wrapper's by tie group, the backstop on (an explicit pool) over the
    fused engine."""
    data = synthetic_retrieval(1024, 64, 32, seed=5)
    jdb = JIndex(config=JCfg(dim=32), n_subtrees=2, seed=0)
    tdb = CobwebIndex(config=TreeConfig(dim=32), n_subtrees=2, seed=0,
                      device="cpu")
    layouts = []
    orig = tidx.backstop_topk

    def spy(wemb, half, queries, c, n_valid, *layout):
        layouts.append((wemb.dtype, tuple(wemb.shape), layout))
        return orig(wemb, half, queries, c, n_valid, *layout)

    for db in (jdb, tdb):
        db.add_sentences([None] * 1024, data.corpus_embs)
        db.blocked_threshold = 256
        db.backstop_pool = 64
        db.emb_store_dtype = "bfloat16"
    jdb._emb_dev_cache = None
    jdb._wemb_dev_cache = None
    tidx.backstop_topk = spy
    try:
        got = tdb.query_ids(data.query_embs, 10, rerank=32).numpy()
    finally:
        tidx.backstop_topk = orig
    want = np.asarray(jdb.query_ids(data.query_embs, 10, rerank=32))
    assert layouts[0][0] == torch.bfloat16 and layouts[0][2] == (False,)
    assert layouts[0][1][1] == 32                     # (rows, D)
    _hold_ids(data.corpus_embs, data.query_embs, want, got)


def test_to_device_cpu_on_a_cpu_forest_changes_nothing():
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(96, 8)).astype(np.float32)
    vf = VForest(TreeConfig(dim=8), n_subtrees=2, capacity_per_tree=256,
                 device="cpu")
    vf.add(xs)
    idx = vf.flat_index()
    st = vf.state
    ptrs = [getattr(st, f).data_ptr() for f in tree_mod.FIELDS]
    gen = vf._gen.get_state().clone()
    vf.to_device("cpu")
    vf.to_device()
    assert vf.state is st and vf.flat_index() is idx
    assert ptrs == [getattr(vf.state, f).data_ptr() for f in tree_mod.FIELDS]
    assert torch.equal(vf._gen.get_state(), gen)
    db = CobwebIndex(corpus_embeddings=xs, config=TreeConfig(dim=8),
                     n_subtrees=2, device="cpu", build_device="cpu")
    before = db.query_ids(xs[:8], 5).numpy()
    emb = db._emb_device()
    db.promote_build_device()
    assert db._emb_device() is emb
    np.testing.assert_array_equal(db.query_ids(xs[:8], 5).numpy(), before)


def test_compressed_forest_file_cross_loads(compressed, tmp_path):
    """A compressed forest's file: the port writes the bf16 stats as the
    JAX package does (2-byte records), reads its own back compressed and
    bit for bit, and reads the JAX package's file to the JAX state's
    bits.  (The JAX package cannot read such a file back itself.)"""
    jdb, tdb, _, _ = compressed
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tdb.forest.save_npz(mine)
    jdb.forest.save_npz(theirs)
    with np.load(mine) as a, np.load(theirs) as b:
        assert a["st_means"].dtype.itemsize == b["st_means"].dtype.itemsize
        assert a["st_means"].dtype.kind == b["st_means"].dtype.kind == "V"
    back, _ = VForest.load_npz(mine, device="cpu")
    assert back.state.means.dtype == torch.bfloat16
    cap = back.state.capacity
    for name in tree_mod.FIELDS:     # the scratch row aside
        a, b = getattr(back.state, name), getattr(tdb.forest.state, name)
        if a.dim() >= 2:
            a, b = a[:, :cap], b[:, :cap]
        assert torch.equal(a.contiguous().view(-1).view(torch.uint8),
                           b.contiguous().view(-1).view(torch.uint8)), name
    jvf, _ = VForest.load_npz(theirs, device="cpu")
    jst = jax.device_get(jdb.forest.state)
    cap = jvf.state.capacity
    np.testing.assert_array_equal(_bits(jvf.state.means[:, :cap]),
                                  _bits(jst.means))
    np.testing.assert_array_equal(_bits(jvf.state.m2s[:, :cap]),
                                  _bits(jst.m2s))


def test_single_tree_compress_and_add():
    """The single tree: ``compress_stats`` casts its state as the JAX
    wrapper does, serving stays equal by tie group, the inspection paths
    read f32 (the JAX ``_host_arrays`` upcast, which its ``save_npz``
    writes too), a CPU build ignores ``build_device`` and an add into the
    compressed tree lands where the JAX package puts it.  The CUDA-graph
    step is recaptured for the new tensors: it never replays over a
    freed f32 state."""
    data = synthetic_retrieval(160, 16, 16, seed=4)
    jdb = JIndex(config=JCfg(dim=16), corpus_embeddings=data.corpus_embs)
    tdb = CobwebIndex(config=TreeConfig(dim=16),
                      corpus_embeddings=data.corpus_embs, device="cpu",
                      build_device="cpu")
    assert tdb.forest is None
    for db in (jdb, tdb):
        db.compress_stats()
    assert tdb.tree.state.means.dtype == torch.bfloat16
    jst = jax.device_get(jdb.tree.state)
    assert np.abs(_bits(tdb.tree.state.means[0, :-1])
                  - _bits(jst.means)).max() <= 1
    host = tdb.tree.host_arrays()
    assert host["means"].dtype == np.float32
    np.testing.assert_allclose(host["m2s"], jdb.tree._host_arrays().m2s,
                               rtol=2.0 ** -7, atol=1e-6)
    _hold_ids(data.corpus_embs, data.query_embs,
              np.asarray(jdb.query_ids(data.query_embs, 5)),
              tdb.query_ids(data.query_embs, 5).numpy())
    extra = (data.corpus_embs[:12] + 0.05).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(tdb.add_sentences([None] * 12, extra)),
        np.asarray(jdb.add_sentences([None] * 12, extra)))
    jst = jax.device_get(jdb.tree.state)
    assert np.abs(_bits(tdb.tree.state.means[0, :-1])
                  - _bits(jst.means)).max() <= 1


def test_state_key_and_graph_guard():
    """The step graph's key names each state array's address and dtype (a
    cast may reuse a freed address), and a graph is never captured over a
    state on the host."""
    st = tree_mod.init_state(2, 16, 4, 3, "cpu")
    cst = tree_mod.compress_state(st)
    assert tree_mod._state_key(st) != tree_mod._state_key(cst)
    assert cst.means.dtype == torch.bfloat16
    assert tree_mod.grow_state(cst, 64).means.dtype == torch.bfloat16
    raw = tree_mod.state_to_numpy(cst, raw=True)
    assert raw["means"].dtype.kind == "V" and raw["means"].itemsize == 2
    assert tree_mod.state_to_numpy(cst)["means"].dtype == np.float32
    back = tree_mod.state_from_numpy(raw, "cpu")
    assert back.means.dtype == torch.bfloat16
    assert tree_mod.state_bytes(cst) < tree_mod.state_bytes(st)
    with pytest.raises(ValueError):
        tree_mod.StepGraph(st, TreeConfig(dim=4, max_fanout=3))


def _smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_memory_tools_phase_on_the_host():
    """``chip_smoke.py``'s phase 3g rehearsed on the host at a small size
    (a whitener-mode 8-lane forest of 1200 rows with the backstop on, 256
    queries; a 512-row host build at (d)): every step's checks pass, the
    bf16 store halves the store's bytes, compression shrinks the state,
    the offload keeps the ids, and the host build equals itself."""
    from rag_cobweb_tpu_torch.bench import probes
    from rag_cobweb_tpu_torch.bench.datasets import (
        synthetic_retrieval_hard as hard)
    from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel
    data = hard(1200, 256, 32, seed=2)
    w = PCAICAWhiteningModel.fit(data.corpus_embs, pca_dim=16,
                                 ica_max_iter=200, seed=0)
    db = CobwebIndex(config=TreeConfig(dim=w.dim_out), n_subtrees=8,
                     whitener=w, device="cpu")
    db.add_sentences([None] * 1200, data.corpus_embs)
    db.blocked_threshold = 256
    db.backstop_threshold = 512
    db.rerank_candidates = 64
    out = _smoke().memory_tools_slice(
        db, data, probes.zero_counters, probes.read_counters, device="cpu",
        batch=128, pool=64, small_corpus=600, small_queries=60,
        cpu_rows=512, dim=32, card=False)
    assert 2 * out["a"]["store_bytes"][1] == out["a"]["store_bytes"][0]
    assert out["b"]["state_bytes"][1] < out["b"]["state_bytes"][0]
    assert out["c"]["ids_equal_b"]
    assert out["c"]["added_rows_found_first"] == 1024
    assert out["d"]["plain"]["queries_differing_from_plain"] == 0
    assert out["d"]["structure_equal_device_build"]


def test_million_bench_rehearses_on_the_host(tmp_path):
    """``bench/million.py`` end to end on the host at a small size with
    every tool on and an explicit backstop: two checkpoints, the bytes of
    each component after each tool (the stats and the store halved, the
    state offloaded), a product row beside the row without the backstop
    and the exact scan, and the data cached for the next run."""
    from rag_cobweb_tpu_torch.bench import million
    kw = dict(size=1536, checkpoints=(768, 1536), queries=48, dim=32,
              pca_dim=16, vforest=8, batch=32, rerank=48, raw_store=True,
              backstop=48, compress_stats=True, emb_bf16=True,
              offload_state=True, device="cpu", cache_dir=tmp_path)
    recs = million.run(**kw)
    assert [r["size"] for r in recs] == [768, 1536]
    by = recs[0]["bytes"]     # the tools stay on past the first checkpoint
    assert list(by) == ["built", "compress_stats", "fused_index",
                        "emb_bf16", "offload_state"]
    assert by["compress_stats"]["forest_state"] < by["built"]["forest_state"]
    assert by["compress_stats"]["forest_stats_dtype"] == "bfloat16"
    assert 2 * by["emb_bf16"]["raw_store"] == by["fused_index"]["raw_store"]
    assert by["fused_index"]["fused_index"] > 0
    assert recs[1]["bytes"]["built"]["raw_store_dtype"] == "bfloat16"
    for r in recs:
        assert r["backstop"] == 48 and r["queries"] > 0
        for row in ("product", "product_nobackstop", "exact"):
            assert 0 < r[row]["recall@10"] <= 1, (row, r[row])
        assert r["product"]["recall@10"] >= r["exact"]["recall@10"] - 0.1
    assert len(list(tmp_path.glob("*.npz"))) == 1
