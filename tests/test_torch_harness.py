"""The port's benchmark harness and its tooling (``bench/harness.py``,
``metrics``, ``report``, ``datasets``, ``encoders``, ``launcher``,
``case_study``) against the JAX package's, on the CPU.

Both harnesses run the same synthetic data (seed 42, 400 corpus rows, 60
queries, 64-d, the "golden" matrix: flat IP, the beam and fast rows of one
PCA+ICA single tree).  Tolerances: the flat rows are one exact float32
product in each package, so their ids and metrics are equal; each
package builds its own tree from its own float32 whitening, so a cobweb
row's recall@10 may differ by one query (1/60); the table round-trips to
its printed digits (recall 4 decimals: 5e-5; latency 3: 5e-4)."""

import json
import os
import sys
import time
import types

import jax  # noqa: F401  (the JAX package runs on the CPU: conftest)
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.bench import baselines as jbaselines
from rag_cobweb_tpu.bench import case_study as jcase
from rag_cobweb_tpu.bench import datasets as jdatasets
from rag_cobweb_tpu.bench import encoders as jencoders
from rag_cobweb_tpu.bench import harness as jharness
from rag_cobweb_tpu.bench import launcher as jlauncher
from rag_cobweb_tpu.bench import metrics as jmetrics
from rag_cobweb_tpu.bench import report as jreport
from rag_cobweb_tpu_torch.bench import (baselines, case_study, datasets,
                                        encoders, harness, launcher,
                                        metrics, report)

torch.set_num_threads(1)

SETTINGS = dict(model_name="synthetic", subset_size=400, target_size=60,
                top_k=10, method="golden", dim=64, seed=42)
# test_golden.py's bands for these rows
BANDS = {"Flat IP": (0.97, 1.0), "Cobweb PCA+ICA Fast": (0.95, 1.0),
         "Cobweb PCA+ICA (beam)": (0.95, 1.0)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jroot = tmp_path_factory.mktemp("jax_harness")
    troot = tmp_path_factory.mktemp("torch_harness")
    jres = jharness.BenchmarkRunner("synthetic", root=str(jroot)).run(
        **SETTINGS)
    runner = harness.BenchmarkRunner("synthetic", root=str(troot))
    tres = runner.run(**SETTINGS, device="cpu")
    return {"jax": {r["method"].replace(" (TPU)", ""): r for r in jres},
            "torch": {r["method"].replace(" (CPU)", ""): r for r in tres},
            "runner": runner, "jroot": jroot, "troot": troot,
            "rows": tres}


def test_rows_are_named_by_device_and_sit_in_the_golden_bands(runs):
    names = [r["method"] for r in runs["rows"]]
    assert names == ["Flat IP (CPU)", "Cobweb PCA+ICA (beam) (CPU)",
                     "Cobweb PCA+ICA Fast (CPU)"]
    for name, (lo, hi) in BANDS.items():
        assert lo <= runs["torch"][name]["recall@10"] <= hi, name


def test_flat_rows_equal_the_jax_harness(runs):
    t, j = runs["torch"]["Flat IP"], runs["jax"]["Flat IP"]
    for key in j:
        if key.startswith(("recall@", "mrr@", "ndcg@")):
            assert t[key] == j[key], key
    e = runs["runner"].embeddings
    want = jbaselines.make_flat_retriever(e["corpus"], "ip")(e["queries"],
                                                              10)
    got = baselines.make_flat_retriever(e["corpus"], "ip", device="cpu")(
        e["queries"], 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jbaselines.make_flat_retriever(e["corpus_w"], "l2")(
        e["queries_w"], 10)
    got = baselines.make_flat_retriever(e["corpus_w"], "l2",
                                        device="cpu")(e["queries_w"], 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("row", ["Cobweb PCA+ICA (beam)",
                                 "Cobweb PCA+ICA Fast"])
def test_cobweb_rows_within_one_query_of_the_jax_harness(runs, row):
    n = SETTINGS["target_size"]
    assert abs(runs["torch"][row]["recall@10"]
               - runs["jax"][row]["recall@10"]) <= 1.0 / n + 1e-12


def test_artifact_round_trips_in_both_packages(runs):
    tfiles = report.collect_results(str(runs["troot"] / "outputs"))
    jfiles = jreport.collect_results(str(runs["jroot"] / "outputs"))
    assert list(tfiles) == list(jfiles)        # the same run id and path
    (path_rows,) = tfiles.values()
    assert jreport.collect_results(str(runs["troot"] / "outputs")) \
        == tfiles
    for parsed, row in zip(path_rows, runs["rows"]):
        assert parsed["method"] == row["method"]
        assert abs(parsed["recall@10"] - row["recall@10"]) <= 5e-5
        assert abs(parsed["avg_latency_ms"] - row["avg_latency_ms"]) <= 5e-4
    (jrows,) = jfiles.values()
    assert report.parse_results_file(
        str(runs["jroot"] / "outputs" / list(jfiles)[0])) == jrows


def _lossy_cache(root, uid):
    """Sentence caches (no ids file) of a corpus whose rows 1 and 2 differ
    only by a newline; the gold of query 0 is row 2."""
    corpus = [f"passage {i}" for i in range(40)]
    corpus[1], corpus[2] = "a b", "a\nb"
    queries, targets = ["q0", "q1"], [corpus[2], corpus[7]]
    for kind, rows in (("corpus", corpus), ("queries", queries),
                       ("targets", targets)):
        jencoders.save_sentences(
            jencoders.sentences_cache_path(str(root), kind, uid), rows)
    rng = np.random.default_rng(0)
    return (rng.normal(size=(40, 8)).astype(np.float32),
            rng.normal(size=(2, 8)).astype(np.float32))


def test_lossy_cache_jax_persists_a_wrong_id_the_port_raises(tmp_path):
    kw = dict(model_name="m", subset_size=40, target_size=2, top_k=5,
              method="flat_ip", split="validation")
    uid = jencoders.generate_unique_id("m", "qqp", "validation", 40, 2,
                                       top_k=5)
    embs, qs = _lossy_cache(tmp_path / "jax", uid)
    jharness.BenchmarkRunner("qqp", root=str(tmp_path / "jax")).run(
        **kw, corpus_embs=embs, query_embs=qs, target_dim=4)
    ids = np.load(jencoders.target_ids_cache_path(str(tmp_path / "jax"),
                                                  uid))
    assert ids.tolist() == [1, 7]           # the gold is row 2
    _lossy_cache(tmp_path / "torch", uid)
    ids_path = encoders.target_ids_cache_path(str(tmp_path / "torch"), uid)
    runner = harness.BenchmarkRunner("qqp", root=str(tmp_path / "torch"))
    with pytest.raises(ValueError, match="ids file"):
        runner.run(**kw, corpus_embs=embs, query_embs=qs, target_dim=4,
                   device="cpu")
    with pytest.raises(ValueError, match=ids_path):
        runner.run(**kw, corpus_embs=embs, query_embs=qs, target_dim=4,
                   device="cpu")
    assert not os.path.exists(ids_path)


def test_ids_file_is_written_from_the_dataset_before_its_caches(
        tmp_path, monkeypatch):
    """A fresh run takes its ids from the dataset's own strings (row 2,
    though its cached text equals row 1's) and persists them; the next
    run reads the caches and that file."""
    corpus = [f"passage {i}" for i in range(40)]
    corpus[1], corpus[2] = "a b", "a\nb"
    data = datasets.RetrievalDataset(corpus, ["q0"], [corpus[2]], "fake")
    runner = harness.BenchmarkRunner("qqp", root=str(tmp_path))
    monkeypatch.setattr(runner, "load_data", lambda *a, **k: data)
    rng = np.random.default_rng(0)
    embs = rng.normal(size=(40, 8)).astype(np.float32)
    kw = dict(model_name="m", subset_size=40, target_size=1, top_k=5,
              method="flat_ip", corpus_embs=embs, query_embs=embs[2:3],
              target_dim=4, device="cpu")
    first = runner.run(**kw)
    uid = encoders.generate_unique_id("m", "qqp", "validation", 40, 1,
                                      top_k=5)
    assert np.load(encoders.target_ids_cache_path(str(tmp_path),
                                                  uid)).tolist() == [2]
    monkeypatch.setattr(runner, "load_data", None)    # caches only now
    second = runner.run(**kw)
    assert first[0]["recall@5"] == second[0]["recall@5"] == 1.0


# ---------------------------------------------------------------- loaders

def _fake_datasets(monkeypatch):
    """An in-memory ``datasets`` module: QQP, MS-MARCO and STS-B rows made
    from a seed (nothing is fetched)."""
    rng = np.random.default_rng(3)

    def qqp(split):
        return [{"question1": f"q1 {split} {i}", "question2":
                 f"q2 {split} {i}", "label": int(rng.random() < 0.4)}
                for i in range(300)]

    def marco(split):
        rows = []
        for i in range(120):
            texts = [f"p {split} {i} {j}" for j in range(4)]
            if i % 7 == 0:
                texts[1] = "shared passage"
            sel = [int(j == i % 4 and i % 3 != 0) for j in range(4)]
            rows.append({"query": f"query {i}", "passages": {
                "passage_text": texts, "is_selected": sel}})
        return rows

    def stsb(split):
        return [{"sentence1": f"s1 {split} {i}", "sentence2":
                 f"s2 {split} {i}", "label": float(rng.uniform(0, 5))}
                for i in range(50)]

    tables = {("glue", "qqp"): qqp, ("ms_marco", "v2.1"): marco,
              ("glue", "stsb"): stsb}
    cache = {}

    def load_dataset(name, config, split):
        key = (name, config, split)
        if key not in cache:
            cache[key] = tables[(name, config)](split)
        return cache[key]

    mod = types.ModuleType("datasets")
    mod.load_dataset = load_dataset
    monkeypatch.setitem(sys.modules, "datasets", mod)


def test_text_loaders_equal_the_jax_loaders(monkeypatch):
    _fake_datasets(monkeypatch)
    assert datasets.hf_available() and jdatasets.hf_available()
    for fn in ("load_qqp", "load_ms_marco"):
        for args in ((50, 20, "train", 1), (200, 90, "validation", 7)):
            got = getattr(datasets, fn)(*args)
            assert got == getattr(jdatasets, fn)(*args)
            assert all(t in got.corpus for t in got.targets)
    for thr in (None, 2.5):
        p, s = datasets.load_sts("train", thr)
        jp, js = jdatasets.load_sts("train", thr)
        assert p == jp
        np.testing.assert_array_equal(s, js)

    def enc(texts):
        return np.asarray([[len(t), t.count("1")] for t in texts],
                          np.float32)

    for a, b in zip(datasets.combine_sts_splits(enc, score_threshold=1.0),
                    jdatasets.combine_sts_splits(enc, score_threshold=1.0)):
        np.testing.assert_array_equal(a, b)
    assert datasets.load_sample_corpuses() == \
        jdatasets.load_sample_corpuses()


def test_embedding_files(tmp_path):
    path = str(tmp_path / "sub" / "e.npy")
    assert datasets.load_embeddings(path) is None
    x = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    datasets.save_embeddings(path, x)
    np.testing.assert_array_equal(datasets.load_embeddings(path), x)
    np.testing.assert_array_equal(jdatasets.load_embeddings(path), x)


# ----------------------------------------------------------------- tables

def _results(rng, n):
    out = []
    for i in range(n):
        r = {"method": ["Flat IP (CUDA)", "Cobweb PCA+ICA Fast (CUDA)",
                        "HNSW (native C++)", "Annoy"][i % 4]}
        for k in metrics.K_VALUES:
            r[f"recall@{k}"] = float(rng.choice([1.0, 0.0, rng.random()]))
            r[f"mrr@{k}"] = float(rng.random())
            r[f"ndcg@{k}"] = float(rng.choice([rng.random(), np.nan]))
        r["avg_latency_ms"] = float(rng.choice([1e-5, 0.0018, 12.34, 812.0,
                                                np.inf]))
        r["qps"] = float(rng.choice([3.3, 812.0, 250000.25, 1e6 + 0.3,
                                     np.nan]))
        out.append(r)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_metrics_table_equals_tabulates_grid(seed, tmp_path):
    pytest.importorskip("tabulate")
    rng = np.random.default_rng(seed)
    res = _results(rng, seed)
    top_k = [100, 10, 5, 2, 20, 50][seed]
    want = jmetrics.print_metrics_table(res, str(tmp_path / "j.txt"),
                                        top_k=top_k)
    got = metrics.print_metrics_table(res, str(tmp_path / "t.txt"),
                                      top_k=top_k)
    assert got == want
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt") \
        .read_text()


def test_retrieval_metrics_equal_the_jax_metrics():
    rng = np.random.default_rng(0)
    ids = rng.integers(-1, 30, size=(40, 20))
    gold = rng.integers(0, 30, size=40)
    assert metrics.retrieval_metrics(ids, gold, 20) == \
        jmetrics.retrieval_metrics(ids, gold, 20)


def test_evaluate_retrieval_remeasures_once_under_a_slow_control():
    """The control (a batch slower than its threshold) takes the whole
    measurement once more and no more; a fast one none."""
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(64, 8)).astype(np.float32)
    qs = corpus[:20] + 0.01
    calls = {"r": 0, "c": 0}
    flat = baselines.make_flat_retriever(corpus, "ip", device="cpu")

    def retrieve(q, k):
        calls["r"] += 1
        return flat(q, k)

    def slow_control(q, k):
        calls["c"] += 1
        time.sleep(0.02)
        return flat(q, k)

    out = metrics.evaluate_retrieval("x", retrieve, qs, np.arange(20), 5,
                                     batch_size=8, control_fn=slow_control,
                                     control_threshold_ms=5.0)
    assert out["control_requeued"] is True
    assert out["control_batch_ms"] > 5.0
    # warm-up 1 + two measurements of 3 batches and 5 latency probes each
    assert calls["r"] == 1 + 2 * (3 + 5)
    assert calls["c"] == 1 + 2 * 3
    assert out["recall@5"] == 1.0
    out = metrics.evaluate_retrieval("x", retrieve, qs, np.arange(20), 5,
                                     batch_size=8, control_fn=flat,
                                     control_threshold_ms=1e4)
    assert out["control_requeued"] is False
    assert out["latency_vs_control"] > 0


# ---------------------------------------- launcher, encoders, case study

def test_launcher_multihost_script_feeds_launch_config(tmp_path):
    from rag_cobweb_tpu_torch.parallel.distributed import launch_config
    cfg = {"defaults": {"script": "scripts/million_benchmark.py",
                        "slurm": {"partition": "gpu", "nodes": 4}},
           "experiments": [{"name": "pod", "args": {"size": 1000000}},
                           {"name": "b", "slurm": {"time": "00:10:00"},
                            "args": {"subset_size": 200}}]}
    path = tmp_path / "exps.json"
    path.write_text(json.dumps(cfg))
    assert launcher.load_experiments(str(path))[1]["slurm"]["time"] \
        == "00:10:00"
    # the JAX launcher's commands, each with the script's twin in its
    # place (``bench/million.py``) and the device after its arguments
    assert launcher.run_experiments(str(path), dry_run=True) == [
        [c[0], "-m", "rag_cobweb_tpu_torch.bench.million", *c[2:],
         "--device", "cuda"]
        for c in jlauncher.run_experiments(str(path), dry_run=True)]
    (script, _) = launcher.run_experiments(
        str(path), mode="slurm-multihost", script_dir=str(tmp_path / "j"),
        dry_run=True)
    text = open(script).read()
    assert "#SBATCH --nodes=4" in text and "--size 1000000" in text
    assert "srun --kill-on-bad-exit=1" in text
    # the script's exports, as bash would set them on task 3 of node0's job
    env = {"SLURM_NTASKS": "4", "SLURM_PROCID": "3"}
    for line in text.splitlines():
        if line.startswith("export "):
            k, v = line[len("export "):].split("=", 1)
            env[k] = v.strip('"').replace("${COORD_HOST}", "node0") \
                .replace("$SLURM_NTASKS", env["SLURM_NTASKS"])
    assert launch_config(env=env) == ("tcp://node0:12321", 4, 3)
    single = launcher.write_slurm_script(
        launcher.load_experiments(str(path))[1], str(tmp_path / "s"), 1)
    assert "#SBATCH --time=00:10:00" in open(single).read()


NAMES = ["all-roberta-large-v1", "bert-base-uncased", "roberta-base",
         "gpt2", "t5-base", "sentence-transformers/all-MiniLM-L6-v2",
         "facebook/dpr-question_encoder-single-nq-base", "gtr-t5-xl",
         "EleutherAI/gpt-neo-125m", "my-org/custom-model", "all-foo",
         "google/flan-T5-small"]


def test_encoder_ids_and_families_equal_the_jax_functions(tmp_path):
    for name in NAMES:
        assert encoders.infer_model_type(name) == \
            jencoders.infer_model_type(name)
        for kw in ({}, {"top_k": 20}, {"top_k": 10, "pca": 0.96,
                                       "extra": "x" * 80}):
            args = (name, "qqp", "validation", 10000, 1000)
            assert encoders.generate_unique_id(*args, **kw) == \
                jencoders.generate_unique_id(*args, **kw)
    root, uid = str(tmp_path), "u"
    for fn in ("embedding_cache_path", "sentences_cache_path"):
        assert getattr(encoders, fn)(root, "corpus", uid) == \
            getattr(jencoders, fn)(root, "corpus", uid)
    assert encoders.model_cache_path(root, "pca_ica", uid) == \
        jencoders.model_cache_path(root, "pca_ica", uid)
    assert encoders.results_path(root, "qqp", uid) == \
        jencoders.results_path(root, "qqp", uid)
    p = encoders.sentences_cache_path(root, "corpus", uid)
    encoders.save_sentences(p, ["a\nb", "c"])
    assert encoders.load_sentences(p) == jencoders.load_sentences(p) \
        == ["a b", "c"]
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    e = encoders.embedding_cache_path(root, "q", uid)
    assert encoders.load_or_compute(e, lambda: x, compute=False) is None
    np.testing.assert_array_equal(encoders.load_or_compute(e, lambda: x), x)
    np.testing.assert_array_equal(
        jencoders.load_or_compute(e, lambda: None), x)
    out = encoders.encode_corpus_to_npy(["a", "bb", "ccc"], lambda t: np.asarray(
        [[len(s)] for s in t], np.float32), str(tmp_path / "c.npy"), 2)
    np.testing.assert_array_equal(out[:, 0], [1, 2, 3])


def test_case_study_diff_equals_the_jax_function(capsys):
    rng = np.random.default_rng(1)
    a = rng.integers(-1, 50, size=(200, 10))
    b = rng.integers(-1, 50, size=(200, 10))
    gold = rng.integers(0, 50, size=200)
    for k in (1, 5, 10):
        got = case_study.retrieval_diff(a, b, gold, k)
        want = jcase.retrieval_diff(a, b, gold, k)
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])
    d = case_study.retrieval_diff(a, b, gold, 10)
    texts = [f"t{i}" for i in range(200)]
    case_study.print_case_study(d, texts, texts, a, [f"c{i}" for i in
                                                     range(50)])
    port_out = capsys.readouterr().out
    jcase.print_case_study(d, texts, texts, a, [f"c{i}" for i in range(50)])
    assert port_out == capsys.readouterr().out


def test_phase_3k_rehearsal(tmp_path, monkeypatch):
    """``chip_smoke.py`` phase 3k's functions on the host at small sizes:
    the harness (its single tree served by the fused engine, as at the
    card's 10000 rows: the thresholds lowered here), every row's gate, the
    encoder (2 layers, 32 wide) into a 4-lane forest, the trace."""
    import importlib.util
    from pathlib import Path

    from rag_cobweb_tpu_torch.bench import probes
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent /
        "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    setup = CobwebIndex._setup

    def small_setup(self, *a, **k):
        setup(self, *a, **k)
        self.blocked_threshold = 0

    monkeypatch.setattr(CobwebIndex, "_setup", small_setup)
    monkeypatch.setattr(CobwebIndex, "rerank_threshold", 0)
    zero, read = probes.zero_counters, probes.read_counters
    h = cs.harness_phase(zero, read, tmp_path / "harness", device="cpu",
                         subset=600, targets=40, dim=32)
    assert [r["method"] for r in h["rows"]] == [
        n.format(tag="CPU") for n in cs.HARNESS_ROWS]
    assert h["plain"]["queries_differing_from_plain"] == 0
    assert h["flat"]["max_gap_rel"] <= 1e-5
    e = cs.encoder_phase(zero, read, "host", tmp_path / "trace",
                         device="cpu", widths=dict(
                             hidden_size=32, n_layers=2, n_heads=2,
                             intermediate_size=64, vocab_size=4096,
                             max_position_embeddings=64),
                         n_corpus=600, n_queries=50, max_length=32,
                         n_hold=8, n_lanes=4)
    assert e["recall@10"] >= e["exact_recall@10"] - 0.005
    assert (tmp_path / "trace" / "trace.json").exists()
    assert set(e["timer"]) == {"hold against the host", "encode corpus",
                               "fit PCA+ICA", "encode_whiten_insert",
                               "encode queries", "serve"}
    cs.log_benchmark_phase(h, e, "host")


def test_dpr_path_encodes_questions_and_passages_with_their_own_checkpoints(
        tmp_path, monkeypatch):
    """The JAX harness calls ``make_dpr_encoders`` with one checkpoint and
    swaps the pair it returns; the port passes the question checkpoint and
    its ``ctx_encoder`` twin and encodes each side with its own."""
    name = "facebook/dpr-question_encoder-single-nq-base"
    corpus = [f"passage {i}" for i in range(30)]
    data = datasets.RetrievalDataset(corpus, ["q a", "q b"],
                                     [corpus[3], corpus[9]], "fake")
    seen = {}

    def fake_dpr(question_model, ctx_model, **kw):
        seen.update(q=question_model, ctx=ctx_model)
        rng = np.random.default_rng(0)
        table = rng.normal(size=(64, 8)).astype(np.float32)

        def enc(tag):
            return lambda texts: np.stack([
                table[sum(map(ord, tag + t)) % 64] for t in texts])
        return enc("q"), enc("ctx")

    monkeypatch.setattr(encoders, "make_dpr_encoders", fake_dpr)
    runner = harness.BenchmarkRunner("qqp", root=str(tmp_path))
    monkeypatch.setattr(runner, "load_data", lambda *a, **k: data)
    runner.run(model_name=name, subset_size=30, target_size=2, top_k=5,
               method="flat_ip", target_dim=4, use_dpr=True, device="cpu")
    assert seen == {"q": name,
                    "ctx": "facebook/dpr-ctx_encoder-single-nq-base"}
    q_enc, ctx_enc = fake_dpr(name, seen["ctx"])
    np.testing.assert_array_equal(runner.embeddings["corpus"],
                                  ctx_enc(corpus))
    np.testing.assert_array_equal(runner.embeddings["queries"],
                                  q_enc(data.queries))
    jrunner = jharness.BenchmarkRunner("qqp", root=str(tmp_path / "jax"))
    monkeypatch.setattr(jrunner, "load_data", lambda *a, **k: data)
    monkeypatch.setattr(jencoders, "make_dpr_encoders", fake_dpr)
    with pytest.raises(TypeError, match="ctx_model"):
        jrunner.run(model_name=name, subset_size=30, target_size=2,
                    top_k=5, method="flat_ip", target_dim=4, use_dpr=True)
