"""The port's twins of the reference's sweep and profile scripts
(``tuning_sweep``, ``pool_sweep_10k``, ``pcadim_sweep_10k``,
``roofline_benchmark``, ``beam_diag``, ``profile_insert``) beside the
JAX scripts (``scripts/``, run by ``runpy`` with ``sys.argv`` patched,
the persistent compile cache off), on the CPU at small sizes.

Tolerances: recall and coverage figures within one query of the JAX
script's (each package builds its tree from its own float32 whitening);
curve keys, pool lists, widths and dims equal; the exact scans' recall
over the raw rows equal; ``roofline_benchmark``'s operation and byte
counts equal (``bench/roofline.py`` against the JAX module, each row's
model recorded as the script reports it), its times left uncompared;
``profile_insert``'s record with the fields of the JAX line and every
row inserted once the cut descents are retried.  ``pool_sweep_10k`` and
``pcadim_sweep_10k`` take no arguments: both packages' hard synthetic
set is stood in by a smaller one of the same generator."""

import importlib.util
import json
import re
import runpy
import sys
from pathlib import Path

import pytest
import torch

from rag_cobweb_tpu.bench import datasets as jdatasets
from rag_cobweb_tpu.bench import roofline as jroofline
from rag_cobweb_tpu.utils import cache as jcache
from rag_cobweb_tpu_torch.bench import datasets as tdatasets
from rag_cobweb_tpu_torch.bench import roofline as troofline
from rag_cobweb_tpu_torch.scripts import (beam_diag, pcadim_sweep_10k,
                                          pool_sweep_10k, profile_insert,
                                          roofline_benchmark, tuning_sweep)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
SMALL = (1024, 96, 40)      # the 10k scripts' (corpus, queries, dim)


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


@pytest.fixture
def small_hard(monkeypatch):
    """Both packages' ``synthetic_retrieval_hard`` at ``SMALL``, whatever
    sizes a script asks for."""
    for mod in (jdatasets, tdatasets):
        gen = mod.synthetic_retrieval_hard
        monkeypatch.setattr(mod, "synthetic_retrieval_hard",
                            lambda *a, _gen=gen, **k: _gen(*SMALL))


def within_one_query(got: float, want: float, n: int, what=""):
    assert abs(got - want) <= 1 / n + 5e-5, (what, got, want)


# ---------------------------------------------------------------- sweeps

def test_tuning_sweep_equals_the_jax_script(run_jax, capsys):
    args = ["--corpus-size", "1024", "--queries", "96", "--dim", "40",
            "--lanes", "8", "--pools", "0,64,256", "--widths", "2,8"]
    run_jax("tuning_sweep", args)
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    got = tuning_sweep.main(args + CPU)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == got
    assert got.keys() == want.keys()
    for key in ("corpus_size", "dim", "dataset", "routing", "exact_raw"):
        assert got[key] == want[key], key
    within_one_query(got["exact_whitened"], want["exact_whitened"], 96)
    for curve, key in (("pool_curve", "pool"), ("beam_curve",
                                                 "beam_width")):
        assert [p[key] for p in got[curve]] == [p[key] for p in want[curve]]
        for g, w in zip(got[curve], want[curve]):
            assert g.keys() == w.keys()
            within_one_query(g["recall"], w["recall"], 96, (curve, g))


POOL_LINE = re.compile(r"pool=\s*(\d+) approx=(\d): recall@10=(\S+) "
                       r"delta=(\S+) (\S+) ms/q")


def test_pool_sweep_10k_equals_the_jax_script(small_hard, run_jax, capsys):
    """The same lines, in order; each ``approx=0`` recall within one
    query of the JAX script's; ``approx=1`` (no counterpart in the port)
    printed with ``null`` numbers."""
    run_jax("pool_sweep_10k", [])
    jax_out = capsys.readouterr().out
    rec = pool_sweep_10k.main(CPU)
    port_out = capsys.readouterr().out
    want = POOL_LINE.findall(jax_out)
    got = POOL_LINE.findall(port_out)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert len(got) == 8
    for g, w in zip(got, want):
        if g[1] == "1":
            assert g[2:] == ("null", "null", "null")
            continue
        within_one_query(float(g[2]), float(w[2]), SMALL[1], g)
    assert port_out.splitlines()[0] == jax_out.splitlines()[0]   # dim
    ex = re.compile(r"exact\((raw|whitened)\): recall@10=(\S+)")
    (jr, jw), (pr, pw) = ex.findall(jax_out), ex.findall(port_out)
    assert pr == jr
    within_one_query(float(pw[1]), float(jw[1]), SMALL[1])
    assert [p["pool"] for p in rec["pools"]] == [512, 512, 1024, 1024,
                                                 2048, 2048, 4096, 4096]


def test_pcadim_sweep_10k_equals_the_jax_script(small_hard, run_jax,
                                                capsys):
    run_jax("pcadim_sweep_10k", [])
    jax_out = capsys.readouterr().out
    rec = pcadim_sweep_10k.main(CPU)
    port_out = capsys.readouterr().out
    line = re.compile(r"frac=(\S+) dim=(\d+): exact_w=(\S+) cobweb=(\S+) "
                      r"delta_vs_raw=(\S+)")
    want, got = line.findall(jax_out), line.findall(port_out)
    assert len(got) == len(want) == 3
    assert port_out.splitlines()[0] == jax_out.splitlines()[0]
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        for i in (2, 3):
            within_one_query(float(g[i]), float(w[i]), SMALL[1], g)
    assert [f["dim"] for f in rec["fractions"]] == [int(w[1]) for w in want]


DIAG = re.compile(r"\[diag\] (routing coverage L=(\d+): gold-lane hit (\S+)"
                  r"|W=(\d+) L=(\d+): pool-coverage (\S+) recall@10 (\S+))")


def test_beam_diag_equals_the_jax_script(run_jax, capsys):
    """Content routing (the JAX router's host numpy in both packages):
    the same lines; each coverage and recall within one query."""
    args = ["--corpus-size", "1024", "--queries", "96", "--dim", "40",
            "--lanes", "8", "--widths", "4,8", "--probe-lanes", "4,0"]
    run_jax("beam_diag", args)
    want = DIAG.findall(capsys.readouterr().err)
    rec = beam_diag.main(args + CPU)
    got = DIAG.findall(capsys.readouterr().err)
    assert len(got) == len(want) == 2 + 4
    for g, w in zip(got, want):
        assert (g[1], g[3], g[4]) == (w[1], w[3], w[4])
        for i in (2, 5, 6):
            if w[i]:
                within_one_query(float(g[i]), float(w[i]), 96, g)
    assert [b["width"] for b in rec["beam"]] == [4, 4, 8, 8]


# ------------------------------------------------------ roofline, insert

def recorded_models(monkeypatch, mod) -> list:
    """(engine, flops, bytes) of every model ``mod`` reports from here
    on."""
    seen = []
    report = mod.EngineModel.report

    def rec(self, measured_s, batch):
        seen.append((self.name, self.flops, self.hbm_bytes))
        return report(self, measured_s, batch)

    monkeypatch.setattr(mod.EngineModel, "report", rec)
    return seen


def test_roofline_benchmark_counts_equal_the_jax_script(monkeypatch,
                                                        run_jax, capsys):
    """One build each (PCA to a fixed width, so both trees are as wide):
    the same engines in the same order, each model's operations and
    bytes equal where the shapes they read are (the blocked index's NB,
    M and TS printed by both); times are not compared."""
    args = ["--corpus-size", "1024", "--dim", "32", "--pca-dim", "8",
            "--lanes", "8", "--batches", "32", "--rerank", "64",
            "--beam-width", "8", "--dataset", "easy"]
    jseen = recorded_models(monkeypatch, jroofline)
    tseen = recorded_models(monkeypatch, troofline)
    run_jax("roofline_benchmark", args)
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    got = roofline_benchmark.main(args + CPU)
    assert len(jseen) == len(tseen) == len(got["rows"]) == 7
    shape = ("NB", "M", "TS", "sentences", "dim")
    assert [got[k] for k in shape] == [want[k] for k in shape]
    for (jn, jf, jb), (tn, tf, tb), row in zip(jseen, tseen, got["rows"]):
        if jn == "beam_pack":       # its depth is the tree's
            continue
        assert (tf, tb) == (jf, jb), (jn, tn)
        assert row.keys() >= {"engine", "measured_ms", "roofline_frac",
                              "sync_ms"}


PROFILE = re.compile(r"K=\s*(\d+) cap=(\d+) R=(\d+): full\s+(\S+) ms "
                     r"\(\s*(\S+) ms/round,\s+(\S+) ins/s\) \| descend-only"
                     r"\s+(\S+) ms \| retries prefill=(\d+) timed=(\d+) \| "
                     r"1-lane exact retry (\S+) ms \(cold (\S+)\)")


def test_profile_insert_record_has_the_jax_fields(run_jax, capsys):
    args = ["--dim", "16", "--cap", "512", "--rounds", "8", "--prefill",
            "16", "--ks", "4"]
    run_jax("profile_insert", args)
    want = PROFILE.findall(capsys.readouterr().out)
    recs = profile_insert.main(args + CPU)
    got = PROFILE.findall(capsys.readouterr().out)
    assert len(want) == len(got) == len(recs) == 1
    fields = ("K", "cap", "R", "full_ms", "ms_per_round", "inserts_per_s",
              "descend_only_ms", "retries_prefill", "retries_timed",
              "exact_retry_ms", "exact_retry_cold_ms")
    for g, w, r in zip(got, want, recs):
        assert len(g) == len(w) == len(fields)
        assert set(fields) <= r.keys()
        assert g[:3] == w[:3]
        assert (r["K"], r["cap"], r["R"]) == tuple(map(int, w[:3]))
        assert g[6] == "null" and r["descend_only_ms"] is None
        assert r["inserted_after_retries"] == r["rows"] == r["K"] * (16
                                                                     + 16)


# ---------------------------------------------------------- rehearsal

def test_phase_3m_rehearsal(tmp_path, small_hard, capsys):
    """``chip_smoke.py`` phase 3m (b)-(e) on the host at small sizes: the
    sweeps and their recall gates, the scale runs against a host flat
    scan, the roofline rows' shares, the insert profile; the gates that
    need no card."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    small = ["--dim", "40"]
    sw = cs.sweeps_phase(lambda: None, dict, device="cpu", args={
        "pool_sweep_10k": [], "pcadim_sweep_10k": [],
        "tuning_sweep": ["--corpus-size", "1024", "--queries", "96",
                         "--lanes", "8", "--pools", "0,1024",
                         "--widths", "2"] + small,
        "beam_diag": ["--corpus-size", "1024", "--queries", "64",
                      "--lanes", "8", "--widths", "4", "--probe-lanes",
                      "4"] + small}, jax_recall={})
    assert len(sw["served"]) == 3 + 3 + 1
    sc = cs.scale_phase(device="cpu", queries=64, dim=32, runs={
        "forest": {"vforest": 8, "max_size": 800,
                   "checkpoints": (400, 800)}},
        extra=["--pca-dim", "8", "--batch", "32", "--beam-width", "8"])
    assert sc["forest"]["host_flat"] == [
        r["flat_exact_recall@10"] for r in sc["forest"]["rows"]]
    data = tdatasets.synthetic_retrieval(1024, 128, 32)
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel
    w = PCAICAWhiteningModel.fit(data.corpus_embs, pca_dim=8)
    db = CobwebIndex(config=TreeConfig(dim=8), n_subtrees=8, whitener=w,
                     device="cpu")
    db.add_sentences([None] * 1024, data.corpus_embs)
    roof = cs.roofline_rows_hold(db, data, lambda: None, dict,
                                 batches=(32,))
    assert len(roof["rows"]) == 7
    prof = cs.insert_profile(device="cpu", args=[
        "--dim", "16", "--cap", "512", "--rounds", "4", "--prefill", "8",
        "--ks", "4"])
    cs.log_experiments(
        {"rows": 0, "raw_cache_write_s": 0.0, "derive": {},
         "exact_scan": {}, "incremental": {}}, sw, sc, roof, prof, "host")
    assert "[3m] profile_insert" in capsys.readouterr().out
