"""The port's twins of the reference's probes that build large indexes
(``pipeline_probe``, ``run_8m``) or run a benchmark cold
(``ingress_rehearsal``) beside the JAX scripts (``scripts/``, run by
``runpy`` with ``sys.argv`` patched, the persistent compile cache off),
on the CPU at small sizes, and a host rehearsal of ``chip_smoke.py``'s
phase 3n.

Tolerances: recall figures within one query of the JAX script's (both
packages build from the same whitened cache rows, each in its own
float32 arithmetic); sizes, slot counts and byte sizes equal; the row
keys of the JAX record present.  The JAX ``pipeline_probe``'s grouped
arm runs ``approx_max_k`` (its grouped threshold is 2^62 columns, ROADMAP
queue C), so its two arms serve the same ids; the twin's grouped arm
launches kernel 2 (its plain version here) and is held against kernel
2's own plain pool.  ``ingress_rehearsal`` runs both packages' benchmark
cold at 400 rows (``test_harness.py``'s size); the harness finds each
gold by its text, which must match exactly one corpus row.  The small
sizes reach the fused engine by lowering ``blocked_threshold`` and
``rerank_threshold`` in both packages alike."""

import importlib.util
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rag_cobweb_tpu.bench.datasets import synthetic_retrieval_hard as jhard
from rag_cobweb_tpu.core import wrapper as jwrapper
from rag_cobweb_tpu.utils import cache as jcache
from rag_cobweb_tpu_torch.bench import encoders, harness
from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
from rag_cobweb_tpu_torch.core import wrapper as twrapper
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.ops import fused_topk
from rag_cobweb_tpu_torch.scripts import (ingress_rehearsal, pipeline_probe,
                                          run_8m)
from rag_cobweb_tpu_torch.utils import profiling
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


def lowered_thresholds(monkeypatch, blocked: int, mods=(jwrapper,
                                                         twrapper)):
    """The packages' indexes made with ``blocked_threshold`` and
    ``rerank_threshold`` at ``blocked``."""
    for mod in mods:
        init = mod.CobwebIndex.__init__

        def made(self, *a, _init=init, **k):
            _init(self, *a, **k)
            self.blocked_threshold = self.rerank_threshold = blocked

        monkeypatch.setattr(mod.CobwebIndex, "__init__", made)


def within_one_query(got: float, want: float, n: int, what=""):
    assert abs(got - want) <= 1 / n + 5e-5, (what, got, want)


def recall(ids, gold, k: int = 10) -> float:
    return float(np.mean([g in row[:k] for g, row in zip(gold,
                                                         np.asarray(ids))]))


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """A whitened cache (``corpus_w``, ``queries_w``, ``target_ids``) of
    2048 + 256 hard rows, 16 dims, 128 queries."""
    data = synthetic_retrieval_hard(2048 + 256, 128, 48)
    w = PCAICAWhiteningModel.fit(data.corpus_embs[:2048], pca_dim=16,
                                 ica_max_iter=200)
    path = tmp_path_factory.mktemp("cache") / "mb_cache_w.npz"
    np.savez(path, corpus_w=w.transform(data.corpus_embs).astype(np.float32),
             queries_w=w.transform(data.query_embs).astype(np.float32),
             target_ids=data.target_ids)
    return path


def recorded_ids(monkeypatch, mod, calls):
    real = mod.CobwebIndex.query_ids

    def rec_ids(self, queries, k, **kw):
        out = real(self, queries, k, **kw)
        calls.append((np.asarray(queries), np.asarray(out)))
        return out

    monkeypatch.setattr(mod.CobwebIndex, "query_ids", rec_ids)


# ------------------------------------------------------------ pipeline

def test_pipeline_probe_equals_the_jax_script(cache, tmp_path, run_jax,
                                              monkeypatch, capsys):
    """The record's keys (the JAX script's and the twin's additions), the
    index's slot count, the served recall on the first batch within one
    query; the JAX grouped arm equals its approx arm (the reference fault
    the twin does not copy); the twin's grouped arm equals kernel 2's
    plain pool re-ranked exactly."""
    lowered_thresholds(monkeypatch, 512)
    jcalls, tcalls = [], []
    recorded_ids(monkeypatch, jwrapper, jcalls)
    recorded_ids(monkeypatch, twrapper, tcalls)
    args = ["--cache", str(cache), "--size", "2048", "--vforest", "8",
            "--batch", "64", "--pool", "128", "--probes", "2"]
    run_jax("pipeline_probe", args + ["--out", str(tmp_path / "j.json")])
    want = json.loads((tmp_path / "j.json").read_text())
    got = pipeline_probe.main(args + ["--out", str(tmp_path / "t.json")]
                              + CPU)
    capsys.readouterr()
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads(
        json.dumps(got))
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"strided_grouped_vs_exactpool",
                                    "split_overlap"}
    assert got["split_overlap"] is None        # no streams on the host
    for key in ("size", "Sp", "D", "batch", "pool", "k"):
        assert got["config"][key] == want["config"][key], key
    assert want["pool_top10_overlap"] == 1.0    # both JAX arms: approx
    assert got["approx_vs_exactpool"] == 1.0
    with np.load(cache) as z:
        gold = z["target_ids"][:64]
    within_one_query(recall(tcalls[0][1], gold), recall(jcalls[0][1], gold),
                     64)
    for name in ("one_program_grouped_pool", "split_interleaved_4x",
                 "stage_gather_only", "b256_latency"):
        assert "batch_ms" in got[name], name
    assert 0.0 <= got["grouped_vs_exactpool"] <= 1.0


def test_pipeline_probe_grouped_arm_is_kernel_2(cache):
    """The grouped arm's ids: kernel 2's pool (``per_group`` of every
    128 rows, merged) re-ranked by the exact key, equal to the same pool
    taken from ``slab_group_topk_plain`` by hand."""
    with np.load(cache) as z:
        corpus, queries = z["corpus_w"][:2048], z["queries_w"]
    db, _ = pipeline_probe.build(corpus, 8, "cpu", log=lambda *a, **k: None)
    db.blocked_threshold = 512
    n0 = profiling.counter("launch.slab_group_topk")
    rows = pipeline_probe.probe(db, queries, batch=64, pool=128, probes=1,
                                log=lambda *a, **k: None)
    assert profiling.counter("launch.slab_group_topk") == n0  # host: plain
    pg = rows["config"]["per_group"]
    fidx = db._fused_index()
    q = torch.as_tensor(queries[:64])
    s, i = fused_topk.slab_group_topk_plain(
        fused_topk.query_terms(q, fidx.GT.dtype), fidx.GT, fidx.c,
        fidx.valid, pg)
    cs, cand = fused_topk.merge(s, i, 128)
    x = torch.as_tensor(corpus)[cand.long().clamp(max=2047)]
    d2 = torch.sum(torch.square(q.unsqueeze(1) - x), -1)
    d2 = torch.where(cs > fused_topk.NEG / 2, d2, torch.full_like(d2, 1e30))
    want = cand.gather(1, torch.topk(-d2, 10, dim=1).indices)
    ids = torch.as_tensor(rows["served_ids"])
    # the arm's own ids: kernel 2's merged pool through the exact re-rank
    from rag_cobweb_tpu_torch.core import index as index_mod
    live = cs > fused_topk.NEG / 2
    got = index_mod.exact_rerank(
        db._emb_device(), q, torch.where(live, cand, torch.zeros_like(cand)),
        torch.where(live, cs, torch.full_like(cs, float("-inf"))), 10,
        float(db.cfg.prior_var))[1]
    assert torch.equal(got.long(), want.long())
    ovl = np.mean([len(set(a) & set(b)) / 10 for a, b in
                   zip(got.tolist(), ids.tolist())])
    assert rows["grouped_vs_exactpool"] == pytest.approx(ovl)


# -------------------------------------------------------------- run_8m

def test_run_8m_equals_the_jax_script(cache, tmp_path, run_jax, capsys):
    """Two half-forests composed: the record's keys, slot count, byte
    sizes and half rows equal the JAX script's, recall@10 within one
    query; the twin reads back its own half caches and the JAX script's
    (the same layout) and serves within one query of both."""
    args = ["--cache", str(cache), "--size", "2048", "--halves", "2",
            "--vforest", "8", "--batch", "64", "--pool", "128",
            "--backstop", "32"]
    run_jax("run_8m", args + ["--gt-cache", str(tmp_path / "j_{h}.npz"),
                              "--out", str(tmp_path / "j.json")])
    want = json.loads((tmp_path / "j.json").read_text())
    got = run_8m.main(args + ["--gt-cache", str(tmp_path / "t_{h}.npz"),
                              "--out", str(tmp_path / "t.json")] + CPU)
    capsys.readouterr()
    assert set(got) == set(want)
    for key in ("size", "Sp", "pool", "backstop", "gt_gb", "emb_gb"):
        assert got[key] == want[key], key
    assert [h["rows"] for h in got["halves"]] == [1024, 1024]
    assert set(got["halves"][0]) == set(want["halves"][0])
    assert got["hbm_serving_gb"] is None
    within_one_query(got["recall@10"], want["recall@10"], 128)
    for gt, n in (("t", "t2"), ("j", "tj")):
        again = run_8m.main(args + ["--gt-cache", str(tmp_path / f"{gt}_{{h}}.npz"),
                                    "--out", str(tmp_path / f"{n}.json")]
                            + CPU)
        assert all("from_cache" in h for h in again["halves"])
        within_one_query(again["recall@10"], got["recall@10"], 128, gt)


def test_run_8m_serving_equals_the_plain_pipeline(cache):
    """The composed index's served ids against ``bench/probes.plain_check``
    on its sentence-order copy: equal but at ties; a position in half B
    maps past half A's rows."""
    from rag_cobweb_tpu_torch.bench.probes import plain_check
    args = run_8m.parse(["--cache", str(cache), "--size", "2048",
                         "--vforest", "8", "--batch", "64", "--pool", "128",
                         "--backstop", "32", "--gt-cache", ""] + CPU)
    rec, comp = run_8m.run(args, log=lambda *a, **k: None)
    with np.load(cache) as z:
        corpus, queries = z["corpus_w"][:2048], z["queries_w"]
    served = comp.serve(queries, 10).numpy()
    store = torch.as_tensor(corpus).to(torch.bfloat16).float().numpy()
    r = plain_check(comp.as_db(), queries, served, 10, 128, 32, 64, store)
    assert r["queries_differing_from_plain"] <= r["tied_ids"]
    sp_a = comp.parts[0].num_slots
    assert sp_a > 1024
    ids = comp.to_ids(torch.tensor([0, 1023, sp_a, sp_a + 5]))
    assert ids.tolist() == [0, 1023, 1024, 1029]


# ------------------------------------------------------- ingress

def test_ingress_rehearsal_equals_the_jax_script(tmp_path, run_jax, capsys):
    """Both packages' rehearsals at 400 rows, each running its own
    benchmark cold in a subprocess: the same methods, recall@10 within one
    query, the file's rows equal the printed table's."""
    args = ["--subset-size", "400", "--target-size", "60"]
    run_jax("ingress_rehearsal", args + ["--root", str(tmp_path / "j"),
                                         "--cpu"])
    jax_out = capsys.readouterr().out
    got = ingress_rehearsal.main(args + ["--root", str(tmp_path / "t")]
                                 + CPU)
    capsys.readouterr()
    assert "[rehearsal] OK" in jax_out
    uid = encoders.generate_unique_id("all-roberta-large-v1", "qqp",
                                      "validation", 400, 60, top_k=10)
    assert got["uid"] == uid and got["returncode"] == 0
    from rag_cobweb_tpu.bench import report as jreport
    want = jreport.parse_results_file(
        str(tmp_path / "j" / "outputs" / "qqp" / f"benchmark_{uid}.txt"))
    assert got["rows"] == got["printed_rows"]
    assert len(got["rows"]) == len(want) == 3
    for g, w in zip(got["rows"], want):
        assert g["method"].split(" (")[0] == w["method"].split(" (")[0]
        within_one_query(g["recall@10"], w["recall@10"], 60, g["method"])
    # the caches each wrote are the same files
    for kind in ("corpus", "queries"):
        a = np.load(encoders.embedding_cache_path(str(tmp_path / "t"), kind,
                                                  uid))
        b = np.load(encoders.embedding_cache_path(str(tmp_path / "j"), kind,
                                                  uid))
        assert np.array_equal(a, b)


def test_ingress_targets_match_one_row_each(tmp_path):
    """The rehearsal's texts are distinct, so the harness's ids from the
    sentence caches are the generator's gold rows; a target text that
    matches two corpus rows is refused."""
    uid = ingress_rehearsal.write_cache(str(tmp_path), "m", 400, 60,
                                        "validation", 10)
    corpus = encoders.load_sentences(
        encoders.sentences_cache_path(str(tmp_path), "corpus", uid))
    targets = encoders.load_sentences(
        encoders.sentences_cache_path(str(tmp_path), "targets", uid))
    assert len(set(corpus)) == len(corpus) == 400
    ids = harness.target_ids_from_cache(corpus, targets, "ids.npy")
    assert np.array_equal(ids, jhard(400, 60, 768).target_ids)
    dup = list(corpus)
    dup[(ids[0] + 1) % 400] = corpus[ids[0]]
    with pytest.raises(ValueError, match="matches 2 rows"):
        harness.target_ids_from_cache(dup, targets, "ids.npy")


# ----------------------------------------------------- phase 3n rehearsal

def test_phase_3n_rehearsal(cache, tmp_path, monkeypatch):
    """``chip_smoke.py`` phase 3n on the host at small sizes: every twin
    through ``probes_phase``, its holds that need no card (the stages
    against ``query_ids``, the plain pipelines of items 11, 13 and 18,
    the rehearsal's rows, run_8m's recall against the exact scan)."""
    lowered_thresholds(monkeypatch, 512, mods=(twrapper,))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    data = synthetic_retrieval_hard(1024, 96, 40)
    w = PCAICAWhiteningModel.fit(data.corpus_embs, pca_dim=0.96,
                                 ica_max_iter=200)
    flag = twrapper.CobwebIndex(config=TreeConfig(dim=w.dim_out),
                                capacity=4 * 1024 + 16, n_subtrees=32,
                                whitener=w, device="cpu")
    flag.add_sentences([None] * 1024, data.corpus_embs)
    fast = {"probe_fused_epilogue": ["--slots", "5000", "--dim", "8",
                                     "--batch", "16", "--k", "32"],
            "beam_microbench": ["--n", "2000", "--d", "16", "--b", "4",
                                "--w", "4", "--f", "4", "--k-lanes", "2",
                                "--levels", "4"],
            "gather_probe": ["--corpus", "2000", "--batch", "8", "--cand",
                             "16", "--dims", "8,24", "--reps", "1"],
            "pipeline_probe": {"vforest": 8, "batch": 64, "pool": 128},
            "run_8m": ["--vforest", "8", "--batch", "64", "--pool", "128",
                       "--backstop", "32"]}
    cuts = dict(cs.PROBE_CUTS, pipeline_probe={"size": 2048},
                run_8m=["--size", "2048", "--halves", "2"])
    rec = cs.probes_phase(flag, data, cache, tmp_path / "probes",
                          lambda: None, dict, device="cpu", cuts=cuts,
                          fast=fast)
    assert set(rec) == {"rerank_stage_probe", "raw_rerank_probe",
                        "transfer_probe", "probe_fused_epilogue",
                        "beam_microbench", "gather_probe", "pipeline_probe",
                        "ingress_rehearsal", "run_8m"}
    r = rec["rerank_stage_probe"]["rec"]
    assert r["stages_equal_query_ids"]
    assert r["plain"]["queries_differing_from_plain"] <= \
        r["plain"]["tied_ids"]
    for name in ("pipeline_probe", "run_8m"):
        p = rec[name]["rec"]["plain"]
        assert p["queries_differing_from_plain"] <= p["tied_ids"], name
    assert rec["run_8m"]["rec"]["exact_recall@10"] > 0.5
    assert len(rec["raw_rerank_probe"]["rec"]["pools"]) == 3
    cs.log_probes(rec, "host")
