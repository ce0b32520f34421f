"""The port's twins of the reference's data-scale experiment scripts
(``incremental_benchmark``, ``scale_benchmark``, ``exact_scan``,
``derive_caches``) beside the JAX scripts (``scripts/``, run by
``runpy`` with ``sys.argv`` patched, the persistent compile cache off),
on the CPU at small sizes.

Tolerances: recall figures within one query of the JAX script's (each
package builds its tree from its own float32 whitening; with a whitened
cache both build from the same rows); bookkeeping equal (the
staleness flags, the overflow adds, checkpoint sizes, row keys);
``exact_scan``'s ids equal; ``derive_caches``' whitened rows within rtol
1e-5 / atol 1e-6 of the JAX whitener's ``transform_jit`` and its raw
slice bit-equal.  Caches written by either package are read by the
other's scripts.  The small sizes reach the paths the full sizes take
by lowering three thresholds in both packages alike:
``blocked_threshold`` (the fused engine from 8192 rows),
``rerank_threshold`` (the re-rank pool by default from 8192 rows) and
``stale_pending_limit`` (4096 pending rows)."""

import importlib.util
import json
import pickle
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.core import wrapper as jwrapper
from rag_cobweb_tpu.utils import cache as jcache
from rag_cobweb_tpu.whitening import PCAICAWhiteningModel as JPCAICA
from rag_cobweb_tpu_torch import files
from rag_cobweb_tpu_torch.bench import million
from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
from rag_cobweb_tpu_torch.core import wrapper as twrapper
from rag_cobweb_tpu_torch.scripts import (derive_caches, exact_scan,
                                          incremental_benchmark,
                                          scale_benchmark)
from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


@pytest.fixture
def run_jax(monkeypatch):
    """Run ``scripts/<name>.py`` as ``__main__`` with ``argv``."""
    monkeypatch.setattr(jcache, "enable_persistent_cache",
                        lambda *a, **k: None)

    def run(name, argv):
        script = ROOT / "scripts" / f"{name}.py"
        monkeypatch.setattr(sys, "argv", [str(script)] + list(argv))
        runpy.run_path(str(script), run_name="__main__")
    return run


def small_thresholds(monkeypatch, blocked: int, pending: int):
    """Both packages' indexes made with ``blocked_threshold`` and
    ``rerank_threshold`` (8192) at ``blocked`` and
    ``stale_pending_limit`` at ``pending``, alike."""
    for mod in (jwrapper, twrapper):
        init = mod.CobwebIndex.__init__

        def made(self, *a, _init=init, **k):
            _init(self, *a, **k)
            self.blocked_threshold = self.rerank_threshold = blocked
            self.stale_pending_limit = pending

        monkeypatch.setattr(mod.CobwebIndex, "__init__", made)


def json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def within_one_query(got: float, want: float, n: int, what=""):
    assert abs(got - want) <= 1 / n + 5e-5, (what, got, want)


# ---------------------------------------------------------- freshness

def test_incremental_benchmark_equals_the_jax_script(tmp_path, monkeypatch,
                                                     run_jax, capsys):
    """From one whitened cache both packages build the same rows; above
    ``blocked_threshold`` the adds are served stale from the pending
    tier, and the overflow past ``stale_pending_limit`` moves them to the
    delta segment (``_pending_sids`` empty) in both."""
    small_thresholds(monkeypatch, blocked=1024, pending=256)
    data = synthetic_retrieval_hard(2048 + 128, 8, 32)
    cache = tmp_path / "mb_cache_w.npz"
    np.savez(cache, corpus_w=data.corpus_embs)
    args = ["--cache", str(cache), "--size", "2048", "--add", "128",
            "--dim", "32", "--vforest", "8"]
    run_jax("incremental_benchmark", args)
    (want,) = json_lines(capsys.readouterr().out)
    got = incremental_benchmark.main(args + CPU)
    assert json_lines(capsys.readouterr().out) == [got]
    assert got.keys() == want.keys()
    for key in ("size", "added", "stale_served", "overflow_adds",
                "overflow_invalidated"):
        assert got[key] == want[key], key
    assert got["stale_served"] and got["overflow_invalidated"]
    assert got["overflow_adds"] == 256 - 128 + 1
    within_one_query(got["new_sentence_self_hit@10"],
                     want["new_sentence_self_hit@10"], 128)
    assert got["new_sentence_self_hit@10"] == 1.0


# ------------------------------------------------------ streaming scale

SCALE_ARGS = {
    "forest": ["--vforest", "8", "--max-size", "2400", "--checkpoints",
               "800,2400", "--dim", "48", "--pca-dim", "12", "--queries",
               "160", "--batch", "64", "--beam-width", "16"],
    "tree": ["--max-size", "320", "--checkpoints", "160,320", "--dim", "32",
             "--pca-dim", "8", "--queries", "64", "--batch", "32",
             "--beam-width", "16", "--rerank", "64"],
}


@pytest.mark.parametrize("layout", sorted(SCALE_ARGS))
def test_scale_benchmark_equals_the_jax_script(layout, run_jax, capsys):
    """The same checkpoints and row keys; the flat row's recall equal
    (the raw rows, no whitening); the whitened rows' recall within one
    of the queries counted at that checkpoint."""
    args = SCALE_ARGS[layout]
    run_jax("scale_benchmark", args)
    want = json_lines(capsys.readouterr().out)
    got = scale_benchmark.main(args + CPU)
    assert json_lines(capsys.readouterr().out) == got
    assert [r["size"] for r in got] == [r["size"] for r in want]
    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval
    a = dict(zip(args[::2], args[1::2]))
    data = synthetic_retrieval(int(a["--max-size"]), int(a["--queries"]),
                               int(a["--dim"]))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        n = int((data.target_ids < g["size"]).sum())
        assert g["flat_exact_recall@10"] == w["flat_exact_recall@10"]
        for name in ("cobweb_fast", "cobweb_beam", "hnsw_cpp"):
            within_one_query(g[f"{name}_recall@10"],
                             w[f"{name}_recall@10"], n, name)
        assert "cobweb_fast_vs_control" in g


# ----------------------------------------------------------- exact scan

def jax_fold_outputs(monkeypatch) -> list:
    """Every output of a ``jax.jit`` program made from here on."""
    seen = []
    jit = jax.jit

    def recording(fn=None, **kw):
        prog = jit(fn, **kw)

        def call(*a, **k):
            out = prog(*a, **k)
            seen.append(out)
            return out
        return call

    monkeypatch.setattr(jax, "jit", recording)
    return seen


@pytest.mark.parametrize("layout", ["whitened", "raw"])
def test_exact_scan_equals_the_jax_script(layout, tmp_path, monkeypatch,
                                          run_jax, capsys):
    """Chunks of 512 over 2900 rows (a last chunk of 340): the JAX
    script's ids (its last fold's output) equal the twin's, ties (rows
    repeated) in ``jax.lax.top_k``'s order; both read the other's key
    names."""
    rng = np.random.default_rng(4)
    corpus = rng.normal(size=(3000, 16)).astype(np.float32)
    corpus[1000:1010] = corpus[7]             # tied rows, ids 7 and 1000+
    target = rng.choice(3000, 120, replace=False)
    target[:3] = 7
    queries = (corpus[target] + 0.3 * rng.normal(size=(120, 16))
               ).astype(np.float32)
    names = (("corpus_w", "queries_w") if layout == "whitened"
             else ("corpus", "queries"))
    cache = tmp_path / "c.npz"
    np.savez(cache, **{names[0]: corpus, names[1]: queries},
             target_ids=target)
    args = ["--cache", str(cache), "--size", "2900", "--chunk", "512"]
    seen = jax_fold_outputs(monkeypatch)
    run_jax("exact_scan", args)
    jax_out = capsys.readouterr().out
    want_ids = np.asarray(seen[-1][1])
    got = exact_scan.main(args + CPU)
    port_out = capsys.readouterr().out
    np.testing.assert_array_equal(got["ids"], want_ids)
    assert (got["ids"][:3] == 7).any(axis=1).all()
    assert jax_out.splitlines()[0] == port_out.splitlines()[0]
    recall = float(port_out.split("= ")[1].split()[0])
    assert recall == float(jax_out.split("= ")[1].split()[0])
    assert got["recall@10"] == pytest.approx(recall, abs=5e-5)


# -------------------------------------------------------- derived caches

def raw_cache(path: Path, whitener_blob: bytes, n: int = 1500,
              dim: int = 48):
    data = synthetic_retrieval_hard(n, 64, dim)
    np.savez(path, corpus=data.corpus_embs, queries=data.query_embs,
             target_ids=data.target_ids,
             whitener_pickle=np.frombuffer(whitener_blob, np.uint8))
    return data


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_derive_caches_equals_the_jax_script(writer, tmp_path, monkeypatch,
                                            run_jax):
    """A raw cache whose whitener was pickled by either package (the JAX
    package's ``pickle.dumps``, the port's ``files.whitener_pickle``) is
    read by both scripts: the whitened rows within rtol 1e-5 / atol 1e-6
    of each other and of the JAX whitener's ``transform_jit``, the raw
    slices bit-equal.  Then each package's scripts read the other's
    output: ``exact_scan`` on the whitened caches (ids equal), the port's
    ``bench/million.load_data`` and ``incremental_benchmark --cache`` on
    them."""
    fit_rows = synthetic_retrieval_hard(1500, 64, 48).corpus_embs
    jw = JPCAICA.fit(fit_rows, pca_dim=12, ica_max_iter=200)
    tw = files.whitener_from_pickle(pickle.dumps(jw))
    blob = pickle.dumps(jw) if writer == "jax" else files.whitener_pickle(tw)
    raw = tmp_path / "mb_cache_raw.npz"
    data = raw_cache(raw, blob)
    outs = {}
    for who in ("jax", "port"):
        d = tmp_path / who
        d.mkdir()
        args = ["--raw-cache", str(raw), "--whitened-out",
                str(d / "w.npz"), "--raw-slice-out",
                str(d / "hard_s1000_q64_d48_p12.npz"),
                "--raw-slice-size", "1000", "--chunk", "600"]
        if who == "jax":
            run_jax("derive_caches", args)
        else:
            derive_caches.main(args + CPU)
        with np.load(d / "w.npz") as z:
            outs[who] = {k: z[k] for k in z.files}
        with np.load(d / "hard_s1000_q64_d48_p12.npz") as z:
            outs[who + "_slice"] = {k: z[k] for k in z.files}
    ref = np.asarray(jw.transform_jit(jax.numpy.asarray(data.corpus_embs)))
    for key in ("corpus_w", "queries_w"):
        np.testing.assert_allclose(outs["port"][key], outs["jax"][key],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs["port"]["corpus_w"], ref, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(outs["port"]["target_ids"],
                                  data.target_ids)
    for key, v in outs["jax_slice"].items():
        np.testing.assert_array_equal(outs["port_slice"][key], v)
    assert outs["port_slice"]["corpus"].shape == (1000, 48)
    # the other package's files, read by each package's readers
    c, q, t, w = million.load_data(1000, 64, 48, 12,
                                   cache_dir=tmp_path / "jax")
    np.testing.assert_array_equal(c, data.corpus_embs[:1000])
    assert type(w) is PCAICAWhiteningModel
    np.testing.assert_allclose(w.mean, jw.mean)
    seen = jax_fold_outputs(monkeypatch)
    run_jax("exact_scan", ["--cache", str(tmp_path / "port" / "w.npz"),
                           "--k", "5"])
    got = exact_scan.main(["--cache", str(tmp_path / "jax" / "w.npz"),
                           "--k", "5"] + CPU)
    np.testing.assert_array_equal(got["ids"], np.asarray(seen[-1][1]))
    got = incremental_benchmark.main(
        ["--cache", str(tmp_path / "jax" / "w.npz"), "--size", "1200",
         "--add", "16", "--dim", "48", "--vforest", "4"] + CPU)
    assert got["size"] == 1200 and got["added"] == 16


def test_phase_3m_caches_rehearsal(tmp_path, monkeypatch):
    """``chip_smoke.py`` phase 3m (a) on the host at small sizes: the raw
    cache in ``bench/million``'s layout, ``derive_caches`` (the whitened
    rows against ``transform_torch``, the raw slice), ``exact_scan``
    against a one-shot scan, ``incremental_benchmark --cache`` and its
    gates that need no card."""
    small_thresholds(monkeypatch, blocked=1024, pending=256)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    data = synthetic_retrieval_hard(2048 + 256, 128, 48)
    w = PCAICAWhiteningModel.fit(data.corpus_embs[:2048], pca_dim=16,
                                 ica_max_iter=200)
    rec = cs.caches_phase(data, w, tmp_path / "caches", lambda: None,
                          dict, device="cpu", size=2048, slice_size=1024,
                          inc=["--size", "1800", "--add", "128",
                               "--vforest", "8", "--dim", "48"])
    assert rec["derive"]["whitened_max_abs_err"] == 0.0
    assert rec["exact_scan"]["ids_differing"] == 0
    inc = rec["incremental"]
    assert inc["new_sentence_self_hit@10"] == 1.0
    assert inc["stale_served"] and inc["overflow_invalidated"]
