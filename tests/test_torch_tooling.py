"""The port's tooling against the JAX package's, on the CPU: the native
baselines loader (``bench/native.py``), the roofline's counts
(``bench/roofline.py``), ``utils/`` (profiling, logging, the kernels'
build cache, the tree views) and the tree's and wrapper's inspection
methods.  Counts and structures are compared exactly; node variances
within rtol 1e-5 (each package's float32 statistics)."""

import logging
import os
import shutil
import sys
import types
from types import SimpleNamespace

import jax  # noqa: F401  (the JAX package runs on the CPU: conftest)
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.bench import native as jnative
from rag_cobweb_tpu.bench import roofline as jroof
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.core.tree import CobwebTree as JTree
from rag_cobweb_tpu.core.wrapper import CobwebIndex as JIndex
from rag_cobweb_tpu.utils import viz as jviz
from rag_cobweb_tpu_torch.bench import native, roofline
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.tree import CobwebTree
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
from rag_cobweb_tpu_torch.ops import _build
from rag_cobweb_tpu_torch.utils import cache, profiling, viz
from rag_cobweb_tpu_torch.utils.logging import get_logger

torch.set_num_threads(1)


# ------------------------------------------------------------ native

@pytest.fixture(scope="module")
def ann_data():
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no g++ to build native/annlib.cpp")
    assert native.available()
    rng = np.random.default_rng(0)
    return (rng.normal(size=(2000, 32)).astype(np.float32),
            rng.normal(size=(50, 32)).astype(np.float32))


def test_native_library_is_the_ports_own_build(ann_data):
    so = native.library_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.parent.parts[-2:] == ("build", "native")


@pytest.mark.parametrize("metric", ["ip", "l2", "cosine"])
def test_native_flat_topk_equals_numpy_and_the_jax_loader(ann_data, metric):
    corpus, queries = ann_data
    ids, scores = native.flat_topk(corpus, queries, k=10, metric=metric)
    c, q = corpus, queries
    if metric == "cosine":
        c = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        q = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    s = -((q[:, None] - c[None]) ** 2).sum(-1) if metric == "l2" \
        else q @ c.T
    want = np.argsort(-s, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(ids, want)
    np.testing.assert_allclose(scores, np.take_along_axis(s, want, 1),
                               rtol=1e-4, atol=1e-4)
    if jnative.available():
        jids, jscores = jnative.flat_topk(corpus, queries, 10, metric)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(scores, jscores)


def test_native_hnsw_recall_and_retrievers(ann_data):
    """``test_native.py``'s band: recall@10 against the exact cosine scan
    above 0.85 (M=16, ef_construction=200, ef=100)."""
    corpus, queries = ann_data
    idx = native.NativeHNSW(32, M=16, ef_construction=200, ef=100)
    idx.add(corpus[:1000])
    idx.add(corpus[1000:])
    assert len(idx) == 2000
    ids, _ = idx.search(queries, k=10)
    cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    exact = np.argsort(-(qn @ cn.T), axis=1)[:, :10]
    recall = np.mean([len(set(ids[i]) & set(exact[i])) / 10
                      for i in range(len(queries))])
    assert recall > 0.85, recall
    with pytest.raises(ValueError):
        idx.search(queries[:, :8], 3)
    idx.close()
    r = native.make_native_flat_retriever(corpus, "ip")
    assert r(queries[:4], 7).shape == (4, 7)
    rh = native.make_native_hnsw_retriever(corpus)
    got = rh(queries[:3], 5)
    assert got.shape == (3, 5) and (got >= 0).all()


# ---------------------------------------------------------- roofline

SHAPES = [dict(B=1024, S=10000, D=768), dict(B=1, S=131072, D=128),
          dict(B=37, S=5000, D=250)]


@pytest.mark.parametrize("sh", SHAPES)
def test_roofline_counts_equal_the_jax_module(sh):
    B, S, D = sh["B"], sh["S"], sh["D"]
    pairs = [
        ("exact_flat_model", (B, S, D), {}),
        ("exact_flat_model", (B, S, D), {"dtype_bytes": 2}),
        ("blocked_model", (B, 20, 896, 512, D), {}),
        ("blocked_model", (B, 20, 896, 512, D),
         {"dtype_bytes": 2, "fused": True}),
        ("fused_flat_model", (B, S, D), {"dtype_bytes": 2}),
        ("product_path_model", (B, S, D, 1024, 768), {}),
        ("product_path_model", (B, S, D, 512, 768),
         {"d_raw": 768, "backstop": 512, "gt_dtype_bytes": 4}),
        ("gather_path_model", (B, S, 2 * S, D, 12), {}),
        ("beam_model", (B, 8, 64, 16, D), {}),
        ("beam_pack_model", (B, 8, 256, D), {"pack_bytes": 2}),
        ("leaf_rerank_model", (B, 1024, D), {}),
    ]
    for fn, args, kw in pairs:
        got = getattr(roofline, fn)(*args, **kw)
        want = getattr(jroof, fn)(*args, **kw)
        assert (got.flops, got.hbm_bytes, got.gather_rows) == \
            (want.flops, want.hbm_bytes, want.gather_rows), fn
        assert got.name in (want.name, "kernel_blocked", "torch_blocked")
    twoD, Sp = 2 * D, -(-S // 2048) * 2048
    for dt, jdt in ((torch.bfloat16, jax.numpy.bfloat16),
                    (torch.float32, jax.numpy.float32)):
        got = roofline.model_for_fused_index(
            SimpleNamespace(GT=torch.empty((twoD, Sp), dtype=dt)), B)
        want = jroof.model_for_fused_index(
            SimpleNamespace(GT=jax.numpy.empty((twoD, Sp), jdt)), B)
        assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)
        got = roofline.model_for_blocked_index(SimpleNamespace(
            ivt_b=torch.empty((7, 96, D), dtype=dt),
            W=torch.empty((7, 96, 64))), B, fused=True)
        want = jroof.model_for_blocked_index(SimpleNamespace(
            ivt_b=jax.numpy.empty((7, 96, D), jdt),
            W=jax.numpy.empty((7, 96, 64))), B, fused=True)
        assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)


def test_roofline_uses_the_h100_peaks():
    m = roofline.exact_flat_model(1024, 10000, 768)
    assert roofline.H100_HBM_BW == 3.35e12
    assert roofline.H100_PEAK_BF16 == 989e12
    assert roofline.H100_PEAK_F32 == 67e12
    assert m.min_time_s() == max(m.flops / 67e12, m.hbm_bytes / 3.35e12)
    r = m.report(2 * m.min_time_s(), 1024)
    assert r["roofline_frac"] == 0.5 and r["bound"] in ("COMPUTE", "HBM")
    p = roofline.product_path_model(1000, 10240, 248, 1024, 768)
    rows = 1000 * 1024
    assert p.gather_rows == rows
    assert p.bound() == "GATHER"
    assert p.min_time_s() > roofline.gather_time_s(rows, 768 * 4) \
        == rows * 768 * 4 / 3.35e12
    assert not {"V5E_PEAK_BF16", "V5E_HBM_BW", "GATHER_BW",
                "V5E_GATHER_ROWS_PER_S"} & set(vars(roofline))


# ------------------------------------------------------------ utils

def test_phase_timer_accumulates_and_syncs_only_on_the_card():
    t = profiling.PhaseTimer(device="cpu")
    assert t.sync is False
    for _ in range(3):
        with t.phase("a"):
            sum(range(1000))
    with t.phase("b"):
        pass
    d = t.as_dict()
    assert d["a"]["calls"] == 3 and d["b"]["calls"] == 1
    assert d["a"]["total_s"] > 0
    assert t.summary().splitlines()[0].split()[:2] == ["phase", "total_s"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profiling.PhaseTimer()


def test_trace_writes_a_chrome_trace_with_the_annotations(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace"), device="cpu") as prof:
        with profiling.span("bench.matmul"):
            torch.matmul(x, x)
    text = (tmp_path / "trace" / profiling.TRACE_FILE).read_text()
    assert '"bench.matmul"' in text and '"traceEvents"' in text
    assert "bench.matmul" in {e.key for e in prof.key_averages()}


def test_logger_is_idempotent_and_writes_its_file(tmp_path):
    path = tmp_path / "logs" / "run.log"
    a = get_logger("rct_torch_test", level="DEBUG", log_file=str(path))
    b = get_logger("rct_torch_test")
    assert a is b and len(a.handlers) == 2 and a.level == logging.DEBUG
    a.info("hello %d", 7)
    for h in a.handlers:
        h.flush()
    assert "hello 7" in path.read_text()


def test_build_dir_override(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    assert cache.enable_persistent_cache() == cache.DEFAULT_DIR
    got = cache.enable_persistent_cache(str(tmp_path / "k"))
    assert got == tmp_path / "k" == _build.BUILD_DIR and got.is_dir()
    assert _build.library_path("rerank_l2").parent == tmp_path / "k"
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path / "env"))
    assert cache.enable_persistent_cache() == tmp_path / "env"
    # an unwritable directory: the per-user cache under $HOME
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    real = os.access
    monkeypatch.setattr(cache.os, "access", lambda p, m: False if str(
        p).endswith("ro") else real(p, m))
    got = cache.enable_persistent_cache(str(tmp_path / "ro"))
    assert got == tmp_path / "home" / ".cache" / "rag_cobweb_tpu_torch" \
        / "kernels" and got.is_dir()


# -------------------------------------------- tree and wrapper views

def rows(n=48, d=6, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=3.0, size=(4, d))
    return np.concatenate([c + 0.3 * rng.normal(size=(n // 4, d))
                           for c in centers]).astype(np.float32)


def test_node_inspection_equals_the_jax_tree():
    xs = rows()
    jt = JTree(JCfg(dim=6), capacity=256, seed=0)
    jt.fit(xs)
    tt = CobwebTree(TreeConfig(dim=6), capacity=256, seed=0, device="cpu")
    tt.fit(xs)
    assert tt.live_nodes() == jt.live_nodes()
    assert tt.num_nodes() == jt.num_nodes() > len(xs)
    for n in tt.live_nodes():
        np.testing.assert_allclose(tt.node_var(n), jt.node_var(n),
                                   rtol=1e-5, atol=1e-6)


SENTENCES = [f"sentence {i}: " + " ".join(["word"] * (i % 7)) +
             ("\nsecond line" if i % 5 == 0 else "") for i in range(48)]


@pytest.fixture(scope="module")
def indexes():
    xs = rows()
    sents = list(SENTENCES)
    sents[3] = None        # an embedding-only row
    j = JIndex(corpus=sents, corpus_embeddings=xs, config=JCfg(dim=6))
    t = CobwebIndex(corpus=sents, corpus_embeddings=xs,
                    config=TreeConfig(dim=6), device="cpu")
    return j, t


def test_print_tree_equals_the_jax_package(indexes, capsys):
    j, t = indexes
    j.print_tree()
    want = capsys.readouterr().out
    t.print_tree()
    assert capsys.readouterr().out == want
    assert "[Embedding only]" in want and "sids=[0]" in want


class _Digraph:
    """A stand-in for ``graphviz.Digraph`` that records the calls and
    saves them, as if the ``dot`` binary were missing."""

    def __init__(self, comment="", format="png"):
        self.nodes, self.edges, self.attrs = [], [], []

    def attr(self, *a, **kw):
        self.attrs.append((a, kw))

    def node(self, name, label=None, **kw):
        self.nodes.append((name, label, kw))

    def edge(self, a, b):
        self.edges.append((a, b))

    def render(self, path, cleanup=True):
        raise RuntimeError("no dot binary")

    def save(self, path):
        _Digraph.saved[path] = self


def _parse_dot(text):
    """(nodes [(name, label, attrs)], edges) of a DOT source written by
    ``utils/viz.py``."""
    import re
    nodes, edges = [], []
    for line in text.splitlines():
        m = re.match(r'^\t(\S+) -> (\S+)$', line)
        if m:
            edges.append(m.groups())
            continue
        m = re.match(r'^\t(\S+) \[(.*)\]$', line)
        if m and m.group(1) not in ("edge", "node", "graph"):
            kv = dict((k, bytes(v, "utf-8").decode("unicode_escape"))
                      for k, v in re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"',
                                             m.group(2)))
            nodes.append((m.group(1), kv.pop("label"), kv))
    return nodes, edges


def test_viz_dot_sources_equal_the_jax_package(indexes, tmp_path,
                                               monkeypatch):
    j, t = indexes
    _Digraph.saved = {}
    monkeypatch.setitem(sys.modules, "graphviz",
                        types.SimpleNamespace(Digraph=_Digraph))
    j.visualize_subtrees(str(tmp_path / "jax"), num_leaves=4)
    monkeypatch.setattr(viz.shutil, "which", lambda name: None)
    paths = t.visualize_subtrees(str(tmp_path / "torch"), num_leaves=4)
    assert paths and all(p.endswith(".dot") for p in paths)
    want = {os.path.basename(p): g for p, g in _Digraph.saved.items()}
    assert sorted(want) == sorted(os.path.basename(p) for p in paths)
    for p in paths:
        g = want[os.path.basename(p)]
        nodes, edges = _parse_dot(open(p).read())
        assert nodes == [(n, lbl or "", kw) for n, lbl, kw in g.nodes]
        assert edges == g.edges
    with pytest.raises(ValueError, match="single-tree"):
        CobwebIndex(config=TreeConfig(dim=6), n_subtrees=2,
                    device="cpu").print_tree()
    assert jviz._sentence_label(SENTENCES, 5) == \
        viz._sentence_label(SENTENCES, 5)


def test_new_entry_points_refuse_the_host_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from rag_cobweb_tpu_torch.bench import baselines, encoders, harness
    from rag_cobweb_tpu_torch.bench.torch_encoder import (
        TorchEncoder, make_random_encoder, random_bert)
    from rag_cobweb_tpu_torch.bench.torch_encoder import BertConfig
    x = np.zeros((4, 3), np.float32)
    calls = [lambda: harness.BenchmarkRunner(
                 "synthetic", root=str(tmp_path)).run(subset_size=40,
                                                      target_size=4),
             lambda: baselines.make_flat_retriever(x),
             lambda: make_random_encoder(),
             lambda: TorchEncoder(random_bert(BertConfig(
                 hidden_size=8, num_hidden_layers=1, num_attention_heads=2,
                 intermediate_size=16, vocab_size=32))),
             lambda: profiling.PhaseTimer(),
             lambda: profiling.trace(str(tmp_path)).__enter__()]
    if encoders.transformers_available():
        calls.append(lambda: encoders.make_hf_encoder("no-such-model"))
    for make in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
