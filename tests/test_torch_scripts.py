"""The port's twins of the reference's entry points
(``rag_cobweb_tpu_torch/scripts/``) beside the JAX scripts (``scripts/``,
run by ``runpy`` with ``sys.argv`` patched), on the CPU at small sizes.

Tolerances are those of the library each twin calls:
- the harness (``tests/test_torch_harness.py``): flat rows equal to the
  printed digits, a cobweb row's recall@10 within one query (each
  package builds its own tree from its own float32 whitening);
- the query trainer (``tests/test_torch_training.py``): the head starts
  from the JAX trainer's initial parameters; losses within 1e-5
  relative, ``evaluate`` equal;
- FactorVAE (``bench/train_steps``' lockstep): before each step the
  port's trainer takes the JAX trainer's state before that step and its
  draws; every metric within 1e-5 relative (``tc``, a difference of two
  logit means, within 1e-5 of the VAE loss);
- ``compare_whitening``'s correlations within 1e-5.
QQP and MS-MARCO run on ``test_torch_harness``'s in-memory fake
``datasets`` module, with an encoder that maps a text to the row of its
first number plus noise seeded by its hash (a query near its gold).  The
JAX scripts' persistent compile cache is turned off."""

import copy
import hashlib
import json
import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.bench import encoders as jencoders
from rag_cobweb_tpu.training import factorvae as jfv
from rag_cobweb_tpu.training import query_train as jqt
from rag_cobweb_tpu.utils import cache as jcache
from rag_cobweb_tpu_torch.bench import encoders, launcher, report
from rag_cobweb_tpu_torch.scripts import (beam_diag, case_study,
                                          compare_whitening, derive_caches,
                                          exact_scan, incremental_benchmark,
                                          ms_marco_benchmark,
                                          pcadim_sweep_10k, pool_sweep_10k,
                                          profile_insert, qqp_benchmark,
                                          roofline_benchmark,
                                          run_experiments, scale_benchmark,
                                          synthetic_benchmark,
                                          train_factorvae,
                                          train_query_encoder, tuning_sweep,
                                          visualize_tree)
from rag_cobweb_tpu_torch.training import factorvae as tfv
from rag_cobweb_tpu_torch.training import flax_layout
from rag_cobweb_tpu_torch.training import query_train as tqt

from test_torch_harness import _fake_datasets
from test_torch_training import LOSS_RTOL
from test_torch_whitening_trainers import jax_draws, rows

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


def results_rows(root: Path) -> dict:
    """The results table a harness run appended, by method (device tag
    dropped)."""
    (path,) = (root / "outputs").rglob("benchmark_*.txt")
    return {re.sub(r" \((TPU|CPU)\)$", "", r["method"]): r
            for r in report.parse_results_file(str(path))}


def assert_rows_agree(port: dict, ref: dict, n_queries: int):
    assert port.keys() == ref.keys()
    for name, want in ref.items():
        got = port[name]
        for key, w in want.items():
            if not key.startswith(("recall@", "mrr@", "ndcg@")):
                continue
            if name.startswith("Cobweb"):
                assert abs(got[key] - w) <= 1 / n_queries + 5e-5, (name, key)
            else:
                assert got[key] == w, (name, key)


def twin_in(monkeypatch, path: Path, fn, argv):
    path.mkdir()
    monkeypatch.chdir(path)
    return fn(argv + CPU)


# ------------------------------------------------------------ benchmarks

def test_synthetic_benchmark_equals_the_jax_script(tmp_path, monkeypatch,
                                                   run_jax):
    args = ["--subset_size", "400", "--target_size", "60", "--method",
            "golden", "--dim", "64"]
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    run_jax("synthetic_benchmark", args)
    runner = twin_in(monkeypatch, tmp_path / "torch",
                     synthetic_benchmark.main, args)
    assert [r["method"] for r in runner.results] == [
        "Flat IP (CPU)", "Cobweb PCA+ICA (beam) (CPU)",
        "Cobweb PCA+ICA Fast (CPU)"]
    assert runner.dbs["w"].device.type == "cpu"
    assert_rows_agree(results_rows(tmp_path / "torch"),
                      results_rows(tmp_path / "jax"), 60)


BASE = 2.0 * np.random.default_rng(5).normal(size=(512, 32))


def number_encoder(texts):
    """Each text at the row of its first standalone number (none: row 0)
    plus 0.2 x noise seeded by its md5."""
    out = []
    for t in texts:
        nums = re.findall(r"\b\d+\b", t)
        seed = int.from_bytes(hashlib.md5(t.encode()).digest()[:4], "little")
        out.append(BASE[int(nums[0]) % len(BASE) if nums else 0]
                   + 0.2 * np.random.default_rng(seed).normal(size=32))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("name", ["qqp_benchmark", "ms_marco_benchmark"])
def test_text_benchmarks_equal_the_jax_scripts(tmp_path, monkeypatch,
                                               run_jax, name):
    _fake_datasets(monkeypatch)
    for mod in (jencoders, encoders):
        monkeypatch.setattr(mod, "make_encoder",
                            lambda model_name, **kw: number_encoder)
    args = ["--subset_size", "200", "--target_size", "40", "--method",
            "golden", "--model_name", "fake-encoder"]
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    run_jax(name, args)
    twin = {"qqp_benchmark": qqp_benchmark,
            "ms_marco_benchmark": ms_marco_benchmark}[name]
    runner = twin_in(monkeypatch, tmp_path / "torch", twin.main, args)
    assert len(runner.embeddings["queries"]) == 40
    rows = results_rows(tmp_path / "torch")
    assert rows["Flat IP"]["recall@10"] >= 0.9
    assert_rows_agree(rows, results_rows(tmp_path / "jax"), 40)


def test_use_dpr_encodes_with_both_checkpoints(tmp_path, monkeypatch,
                                               run_jax):
    """``--use_dpr``: the twin encodes questions with the question
    checkpoint and passages with its ``ctx_encoder`` twin; the JAX script
    fails in the harness's DPR call (``TypeError``)."""
    _fake_datasets(monkeypatch)
    seen = {}

    def fake_dpr(question_model, ctx_model, **kw):
        seen.update(q=question_model, ctx=ctx_model)
        return number_encoder, number_encoder

    for mod in (jencoders, encoders):
        monkeypatch.setattr(mod, "make_dpr_encoders", fake_dpr)
    name = "facebook/dpr-question_encoder-single-nq-base"
    args = ["--subset_size", "200", "--target_size", "40", "--method",
            "golden", "--model_name", name, "--use_dpr"]
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    with pytest.raises(TypeError, match="ctx_model"):
        run_jax("qqp_benchmark", args)
    twin_in(monkeypatch, tmp_path / "torch", qqp_benchmark.main, args)
    assert seen == {"q": name,
                    "ctx": "facebook/dpr-ctx_encoder-single-nq-base"}
    assert results_rows(tmp_path / "torch")["Flat IP"]["recall@10"] >= 0.9


def test_run_experiments_names_the_twins(tmp_path, monkeypatch, run_jax,
                                         capsys):
    """Dry runs: each experiment's command is its script's twin's with
    ``--device`` (``million_benchmark``'s is ``bench/million.py``); a
    script without a twin raises ``ValueError`` and nothing runs; slurm
    scripts likewise; then one local run of the synthetic twin on the
    host, as a subprocess."""
    small = {"subset_size": 200, "target_size": 20, "method": "scale",
             "dim": 16}
    cfg = {"experiments": [
        {"name": "syn", "args": small},
        {"name": "m", "script": "scripts/million_benchmark.py",
         "args": {"size": 1000}},
        {"name": "tq", "script": "scripts/train_query_encoder.py",
         "args": {"epochs": 1}}]}
    path = tmp_path / "exps.json"
    path.write_text(json.dumps(cfg))
    run_jax("run_experiments", [str(path), "--dry-run"])
    jax_out = capsys.readouterr().out.splitlines()
    got = run_experiments.main([str(path), "--dry-run"])
    assert [str(c) for c in got] == capsys.readouterr().out.splitlines()
    assert len(got) == len(jax_out) == 3
    py = sys.executable
    assert got[0] == [py, "-m", "rag_cobweb_tpu_torch.scripts."
                      "synthetic_benchmark", "--subset_size", "200",
                      "--target_size", "20", "--method", "scale",
                      "--dim", "16", "--device", "cuda"]
    assert got[1] == [py, "-m", "rag_cobweb_tpu_torch.bench.million",
                      "--size", "1000", "--device", "cuda"]
    assert jax_out[1] == str([py, "scripts/million_benchmark.py",
                              "--size", "1000"])
    assert got[2][2:] == ["rag_cobweb_tpu_torch.scripts."
                          "train_query_encoder", "--epochs", "1",
                          "--device", "cuda"]
    twins = {p.stem for p in (
        ROOT / "rag_cobweb_tpu_torch" / "scripts").glob("[!_]*.py")}
    assert len(twins) == 28
    for name in twins:
        assert launcher.experiment_command(
            {"script": f"scripts/{name}.py"}, "cpu")[1:] == [
            "-m", f"rag_cobweb_tpu_torch.scripts.{name}", "--device", "cpu"]
    assert launcher.twin_module("scripts/_bench.py") is None
    # a script without a twin is refused before anything is launched
    untwinned = tmp_path / "untwinned.json"
    untwinned.write_text(json.dumps({"experiments": [
        cfg["experiments"][0],
        {"name": "p", "script": "scripts/torch_multichip_phase.py"}]}))
    monkeypatch.chdir(tmp_path)
    with monkeypatch.context() as m:
        m.setattr(launcher.subprocess, "Popen", None)
        for argv in ([], ["--dry-run"], ["--mode", "slurm"]):
            with pytest.raises(ValueError, match="torch_multichip_phase.py"):
                run_experiments.main([str(untwinned)] + argv)
    assert not (tmp_path / "generated_jobs").exists()
    (script, *_) = run_experiments.main(
        [str(path), "--mode", "slurm", "--dry-run", "--device", "cpu"])
    assert "srun " + py + " -m rag_cobweb_tpu_torch.scripts." \
        "synthetic_benchmark" in open(script).read()
    # a real local run of the first experiment (the twin, on the host)
    path.write_text(json.dumps({"experiments": cfg["experiments"][:1]}))
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    run_experiments.main([str(path), "--device", "cpu"])
    (table,) = (tmp_path / "outputs" / "synthetic").glob("benchmark_*.txt")
    flat, fast = report.parse_results_file(str(table))
    assert flat["method"] == "Flat IP (CPU)" and flat["recall@10"] >= 0.5
    assert fast["method"] == "Cobweb PCA+ICA Fast (CPU)"


# --------------------------------------------------------------- tooling

def test_case_study_equals_the_jax_script(run_jax, capsys):
    args = ["--corpus-size", "300", "--queries", "40", "--dim", "32",
            "--pca-dim", "8", "--k", "10", "--limit", "3"]
    run_jax("case_study", args)
    out = capsys.readouterr().out
    a_only = int(re.search(r"misses \((\d+)\) ===", out).group(1))
    b_only, both, neither = map(int, re.search(
        r"\(also: (\d+) Flat exact IP-only, (\d+) both, (\d+) neither\)",
        out).groups())
    diff = case_study.main(args + CPU)
    port_out = capsys.readouterr().out
    assert port_out.count("[Q") == min(3, len(diff["a_only"]))
    for key, want in (("a_only", a_only), ("b_only", b_only),
                      ("both", both), ("neither", neither)):
        assert abs(len(diff[key]) - want) <= 1, key
    assert sum(len(v) for v in diff.values()) == 40


def dot_graph(path: Path):
    """(nodes with their labels, escapes read, and edges) of a DOT
    source, in order."""
    text = path.read_text()
    nodes = re.findall(r'^\t(\w+) \[label="((?:[^"\\]|\\.)*)"', text, re.M)
    return ([(n, bytes(v, "utf-8").decode("unicode_escape"))
             for n, v in nodes],
            re.findall(r"^\t(\w+) -> (\w+)", text, re.M))


def test_visualize_tree_equals_the_jax_script(tmp_path, run_jax, capsys):
    """The same tree printed (the hash encoder seeds by Python's ``hash``,
    the same within this process) and the same subtree files; with
    ``--model``, a local BERT checkpoint through ``make_local_hf_encoder``."""
    run_jax("visualize_tree", ["--output-dir", str(tmp_path / "jax"),
                               "--num-leaves", "4"])
    jax_out = capsys.readouterr().out
    paths = visualize_tree.main(["--output-dir", str(tmp_path / "torch"),
                                 "--num-leaves", "4"] + CPU)
    port_out = capsys.readouterr().out
    assert port_out.replace("torch", "jax") == jax_out
    # the JAX script's graphviz (where ``dot`` is missing) writes each
    # source as ``<name>.dot`` beside its bare name; attributes quoted
    # differently, the same nodes, labels and edges
    jax_dir = tmp_path / "jax"
    assert paths and sorted(Path(p).name for p in paths) == sorted(
        p.name for p in jax_dir.glob("*.dot"))
    for p in paths:
        assert dot_graph(Path(p)) == dot_graph(jax_dir / Path(p).name)
    pytest.importorskip("transformers")
    from test_torch_encoder import _hf_checkpoint
    ckpt, _ = _hf_checkpoint(tmp_path)
    paths = visualize_tree.main(["--output-dir", str(tmp_path / "bert"),
                                 "--model", ckpt] + CPU)
    assert paths and all(Path(p).exists() for p in paths)


# -------------------------------------------------------------- trainers

def test_train_query_encoder_equals_the_jax_script(tmp_path, monkeypatch,
                                                   run_jax):
    """The head starts from the JAX trainer's initial parameters; the
    per-epoch losses within 1e-5, ``evaluate`` before and after equal."""
    seen = {}
    j_init, j_fit, j_eval = (jqt.CobwebQueryTrainer.__init__,
                             jqt.CobwebQueryTrainer.fit,
                             jqt.CobwebQueryTrainer.evaluate)

    def init(self, *a, **k):
        j_init(self, *a, **k)
        seen["params"] = jax.device_get(self.state.params)

    def fit(self, *a, **k):
        seen["losses"] = j_fit(self, *a, **k)
        return seen["losses"]

    def evaluate(self, *a, **k):
        seen.setdefault("eval", []).append(j_eval(self, *a, **k))
        return seen["eval"][-1]

    for k, f in (("__init__", init), ("fit", fit), ("evaluate", evaluate)):
        monkeypatch.setattr(jqt.CobwebQueryTrainer, k, f)
    t_init = tqt.CobwebQueryTrainer.__init__

    def carried(self, *a, **k):
        t_init(self, *a, **k)
        flax_layout.load_flax(self.head, seen["params"])

    monkeypatch.setattr(tqt.CobwebQueryTrainer, "__init__", carried)
    args = ["--corpus-size", "200", "--queries", "48", "--dim", "32",
            "--pca-dim", "8", "--epochs", "2", "--lr", "1e-3"]
    run_jax("train_query_encoder",
            args + ["--save-dir", str(tmp_path / "jax")])
    out = train_query_encoder.main(
        args + ["--save-dir", str(tmp_path / "torch")] + CPU)
    np.testing.assert_allclose(out["losses"], seen["losses"],
                               rtol=LOSS_RTOL)
    assert [out["before"], out["after"]] == seen["eval"]
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())


def _moments(modules, trees) -> list:
    """Flax trees shaped like ``modules``' parameters, as tensors in the
    modules' parameter order."""
    out = []
    for m, t in zip(modules, trees):
        twin = flax_layout.load_flax(copy.deepcopy(m), t)
        out += [p.detach().clone() for p in twin.parameters()]
    return out


def take_jax_state(tv, st):
    """The port's FactorVAE takes a JAX ``FactorVAEState``: the three
    modules' parameters and both Adam states (optax's count, mu and nu as
    torch's step, exp_avg and exp_avg_sq)."""
    mods = (tv.encoder, tv.decoder, tv.disc)
    for m, p in zip(mods, (st.enc_params, st.dec_params, st.disc_params)):
        flax_layout.load_flax(m, p)
    for opt, ms, adam in ((tv.opt_vae, mods[:2], st.opt_vae[0]),
                          (tv.opt_disc, mods[2:], st.opt_disc[0])):
        trees = adam.mu if len(ms) == 2 else (adam.mu,)
        nus = adam.nu if len(ms) == 2 else (adam.nu,)
        params = opt.param_groups[0]["params"]
        for p, m, v in zip(params, _moments(ms, trees), _moments(ms, nus)):
            opt.state[p] = {"step": torch.tensor(float(adam.count)),
                            "exp_avg": m, "exp_avg_sq": v}


@pytest.fixture
def lockstep_vae(monkeypatch):
    """Lockstep between the packages: each port ``FactorVAE``
    made pairs with the JAX ``FactorVAE`` made in the same order; before
    each of its steps it takes that trainer's state before the same step
    (``take_jax_state``) and draws the randomness that step drew from its
    key.  Returns each pair's per-step metrics (JAX, port) and the JAX
    ``fit`` histories."""
    rec = {"jax": [], "port": [], "hist": []}
    j_init, j_step, j_fit = (jfv.FactorVAE.__init__,
                             jfv.FactorVAE.train_step, jfv.FactorVAE.fit)
    t_init, t_step = tfv.FactorVAE.__init__, tfv.FactorVAE.train_step

    def init(self, *a, **k):
        j_init(self, *a, **k)
        rec["jax"].append([])

    def step(self, state, batch, key):
        new, metrics = j_step(self, state, batch, key)
        rec["jax"][-1].append((jax.device_get(state), key,
                               {k: float(v) for k, v in metrics.items()}))
        return new, metrics

    def fit(self, *a, **k):
        rec["hist"].append(j_fit(self, *a, **k))
        return rec["hist"][-1]

    def t_made(self, *a, **k):
        t_init(self, *a, **k)
        self._jax_steps = iter(rec["jax"][len(rec["port"])])
        rec["port"].append([])
        self._port_metrics = rec["port"][-1]

        def draws(B):
            self._jax_step = next(self._jax_steps)
            take_jax_state(self, self._jax_step[0])
            return jax_draws(self._jax_step[1], B, self.z_dim)
        self.draws = draws

    def t_stepped(self, *a, **k):
        out = t_step(self, *a, **k)
        self._port_metrics.append({k: float(v) for k, v in out.items()})
        return out

    monkeypatch.setattr(jfv.FactorVAE, "__init__", init)
    monkeypatch.setattr(jfv.FactorVAE, "train_step", step)
    monkeypatch.setattr(jfv.FactorVAE, "fit", fit)
    monkeypatch.setattr(tfv.FactorVAE, "__init__", t_made)
    monkeypatch.setattr(tfv.FactorVAE, "train_step", t_stepped)
    return rec


def assert_lockstep(rec, i: int = 0):
    """Pair ``i``'s steps: every metric within 1e-5 relative, ``tc`` (a
    difference of two logit means) within 1e-5 of the VAE loss."""
    want = [m for _, _, m in rec["jax"][i]]
    got = rec["port"][i]
    assert len(got) == len(want) > 0
    for s, (g, w) in enumerate(zip(got, want)):
        for k in ("recon_mse", "kl", "disc", "vae"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                       err_msg=f"step {s} {k}")
        np.testing.assert_allclose(g["tc"], w["tc"], rtol=LOSS_RTOL,
                                   atol=LOSS_RTOL * abs(w["vae"]),
                                   err_msg=f"step {s} tc")


def test_train_factorvae_equals_the_jax_script(tmp_path, run_jax,
                                               lockstep_vae):
    """Two epochs of 4 steps in lockstep: each step's metrics; each
    epoch's history (its last step's metrics, its diagnostics after the
    step: the parameters there part by at most one step's rounding)."""
    np.save(tmp_path / "x.npy", rows(256, 24, 3))
    args = ["--embeddings", str(tmp_path / "x.npy"), "--epochs", "2",
            "--batch-size", "64", "--z-dim", "8", "--gamma", "2",
            "--lr", "1e-3"]
    run_jax("train_factorvae", args + ["--save-dir", str(tmp_path / "jax")])
    out = train_factorvae.main(
        args + ["--save-dir", str(tmp_path / "torch")] + CPU)
    assert_lockstep(lockstep_vae)
    assert len(lockstep_vae["port"][0]) == 8
    (hist,) = lockstep_vae["hist"]
    for got, want in zip(out["history"], hist):
        assert got["epoch"] == want["epoch"]
        np.testing.assert_allclose(got["mean_abs_offdiag"],
                                   want["mean_abs_offdiag"], rtol=1e-5)
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == [
        "factorvae_epoch1.pkl", "factorvae_epoch2.pkl"]


def test_compare_whitening_equals_the_jax_script(monkeypatch, run_jax,
                                                 lockstep_vae):
    reports = []
    j_diag = jfv.latent_correlation_diagnostics

    def diag(z, top_k=10):
        d = j_diag(z, top_k)
        if top_k == 3:                  # the script's reports only
            reports.append(d)
        return d

    monkeypatch.setattr(jfv, "latent_correlation_diagnostics", diag)
    args = ["--samples", "600", "--dim", "32", "--pca-dim", "8",
            "--factorvae-epochs", "1"]
    run_jax("compare_whitening", args)
    got = compare_whitening.main(args + CPU)["reports"]
    assert list(got) == ["raw", "PCA+ICA", "PCA only (normed)", "PCA->ZCA",
                         "ZCA", "FactorVAE latents"]
    assert len(reports) == len(got)
    assert_lockstep(lockstep_vae)
    for (name, g), w in zip(got.items(), reports):
        np.testing.assert_allclose(g["mean_abs_offdiag"],
                                   w["mean_abs_offdiag"], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        assert [p[:2] for p in g["top_pairs"]] == \
            [p[:2] for p in w["top_pairs"]], name
        np.testing.assert_allclose([p[2] for p in g["top_pairs"]],
                                   [p[2] for p in w["top_pairs"]],
                                   atol=1e-5, err_msg=name)


# the arguments a twin requires, where it has any
REQUIRED = {"exact_scan": ["--cache", "mb_cache.npz"],
            "derive_caches": ["--raw-cache", "mb_cache_raw.npz"]}


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
@pytest.mark.parametrize("twin", [synthetic_benchmark, qqp_benchmark,
                                  ms_marco_benchmark, case_study,
                                  visualize_tree, train_query_encoder,
                                  train_factorvae, compare_whitening,
                                  incremental_benchmark, scale_benchmark,
                                  exact_scan, derive_caches, tuning_sweep,
                                  pool_sweep_10k, pcadim_sweep_10k,
                                  roofline_benchmark, beam_diag,
                                  profile_insert],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_twins_refuse_the_host_by_default(twin, tmp_path, monkeypatch):
    """Without ``--device`` a twin asks for the card, and without one it
    raises before any work (no file written, none read)."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main(REQUIRED.get(twin.__name__.rsplit(".", 1)[-1], []))
    assert not any(tmp_path.iterdir())


def test_phase_3l_twins_rehearsal(tmp_path):
    """``chip_smoke.py`` phase 3l (b) on the host (its card run on the
    CPU): the trainers' twins, each returned trainer held in lockstep
    against its host copy (``bench/train_steps.hold``), ``case_study``,
    ``visualize_tree`` and ``run_experiments --dry-run``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rec = cs.twins_phase(tmp_path / "twins", device="cpu", case_corpus=300)
    assert len(rec["train_query_encoder"]["losses"]) == 2
    assert len(rec["train_factorvae"]["recon_mse"]) == 2
    assert len(rec["compare_whitening"]["mean_abs_offdiag"]) == 6
    for name in ("train_query_encoder", "train_factorvae",
                 "compare_whitening"):
        h = rec[name]["hold"]
        assert h["ok"] and h["steps"] == 2, name
        assert h["worst_metric_rel"] == 0.0, name
    assert sum(rec["case_study"].values()) == 100
    assert rec["visualize_tree"]
    cs.log_twins(rec, "host")
