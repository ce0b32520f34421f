"""The port's twins of the reference's TPU probes that need no large
build (``rerank_stage_probe``, ``raw_rerank_probe``, ``transfer_probe``,
``probe_fused_epilogue``, ``beam_microbench``, ``gather_probe``) beside
the JAX scripts (``scripts/``, run by ``runpy`` with ``sys.argv``
patched, the persistent compile cache off), on the CPU at small sizes;
the launcher's map of every reference script to its twin; every twin's
refusal of the host without ``--device cpu``.

These scripts print times; the tests hold what the times are of.  The
values a JAX script computes but does not print are recorded by a
stand-in around ``jax.jit`` (or around the JAX function it calls) and
held against the twin's on the same draws: ``beam_microbench``'s
checksums within rtol 1e-5 (f32 forms) and 1e-2 (bf16 forms),
``gather_probe``'s d2 within rtol 1e-5, ``transfer_probe``'s product
within rtol 1e-5, ``probe_fused_epilogue``'s served pool the same ids but
at ties.  Coverage and recall figures within one query of the JAX
script's (each package builds its forest from its own float32
whitening).  ``raw_rerank_probe`` and ``rerank_stage_probe`` take no
size arguments for the set: both packages' hard synthetic set is stood
in by a smaller one of the same generator, and ``rerank_stage_probe``'s
1024-row forest reaches the fused engine with ``blocked_threshold`` and
``rerank_threshold`` lowered in both packages alike."""

import importlib.util
import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.bench import datasets as jdatasets
from rag_cobweb_tpu.core import index as jindex
from rag_cobweb_tpu.core import wrapper as jwrapper
from rag_cobweb_tpu.utils import cache as jcache
from rag_cobweb_tpu_torch.bench import datasets as tdatasets
from rag_cobweb_tpu_torch.bench import launcher
from rag_cobweb_tpu_torch.core import wrapper as twrapper
from rag_cobweb_tpu_torch.scripts import (beam_microbench, gather_probe,
                                          ingress_rehearsal, pipeline_probe,
                                          probe_fused_epilogue,
                                          raw_rerank_probe,
                                          rerank_stage_probe, run_8m,
                                          transfer_probe)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
SMALL = (1024, 96, 40)      # the stood-in set's (corpus, queries, dim)


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
def jit_outputs(monkeypatch):
    """``jax.jit`` replaced by a recording stand-in: each jitted
    function's outputs, by the function's name, in call order."""
    real, got = jax.jit, {}

    def jit(fn=None, **kw):
        if fn is None:
            return lambda f: jit(f, **kw)
        compiled = real(fn, **kw)

        def call(*a, **k):
            out = compiled(*a, **k)
            got.setdefault(fn.__name__, []).append(np.asarray(out))
            return out
        return call

    monkeypatch.setattr(jax, "jit", jit)
    return got


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


def recall(ids, gold, k: int = 10) -> float:
    return float(np.mean([g in row[:k] for g, row in zip(gold,
                                                         np.asarray(ids))]))


# ----------------------------------------------------------- cheap probes

def test_beam_microbench_checksums_equal_the_jax_forms(run_jax, jit_outputs,
                                                       capsys):
    """Each form's sum of top scores over every level, on the same
    ``default_rng(0)`` draws, against the JAX form's (recorded around
    ``jax.jit``); the production ``beam_pack`` row beside them."""
    args = ["--n", "2000", "--d", "16", "--b", "4", "--w", "4", "--f", "4",
            "--k-lanes", "2", "--levels", "6"]
    run_jax("beam_microbench", args)
    jax_out = capsys.readouterr().out
    rec = beam_microbench.main(args + CPU)
    port_out = capsys.readouterr().out
    for name, rtol in (("gather2xf32", 1e-5), ("gather1xbf16", 1e-2),
                       ("block_slice", 1e-2), ("lanes_vmap", 1e-5)):
        want = jit_outputs[name]
        assert len(want) >= 2 and all(w == want[0] for w in want), name
        np.testing.assert_allclose(rec["forms"][name]["checksum"],
                                   float(want[0]), rtol=rtol, err_msg=name)
        assert re.search(rf"^{name}\s", jax_out, re.M)
        assert re.search(rf"^{name}\s.*checksum", port_out, re.M)
    pack = rec["forms"]["beam_pack"]
    assert np.isfinite(pack["checksum"]) and pack["depth"] >= 2
    assert rec["forms"]["lanes_vmap"]["checksum"] == pytest.approx(
        2 * rec["forms"]["gather2xf32"]["checksum"], rel=1e-5)
    gb = 6 * 4 * 4 * 4 * 16 * 4 * 2 / 1e9
    assert rec["forms"]["gather2xf32"]["gb"] == pytest.approx(gb)
    assert rec["forms"]["gather2xf32"]["bound_ms"] == pytest.approx(
        gb / 3.35e12 * 1e12)


def test_gather_probe_d2_equals_the_xla_gather(run_jax, jit_outputs,
                                               capsys):
    """The twin's d2, plain and through kernel 5's plain version, against
    the JAX script's ``xla_gather_l2`` on the same draws; on the CPU the
    JAX script's Pallas line fails (a TPU kernel), the twin's does not."""
    args = ["--corpus", "5000", "--batch", "8", "--cand", "16", "--dims",
            "8,24", "--reps", "2"]
    run_jax("gather_probe", args)
    jax_out = capsys.readouterr().out
    rec = gather_probe.main(args + CPU)
    port_out = capsys.readouterr().out
    want = jit_outputs["xla_gather_l2"]
    assert len(want) == 2 * (1 + 2)
    for i, D in enumerate((8, 24)):
        ref = want[i * 3]
        np.testing.assert_allclose(rec[D]["d2_first"], ref, rtol=1e-5)
        np.testing.assert_allclose(rec[D]["kernel_d2_first"], ref,
                                   rtol=1e-5)
        assert rec[D]["max_rel_err"] < 1e-4
        assert re.search(rf"\[gather\] D={D} pallas: FAILED", jax_out)
        assert re.search(rf"\[gather\] D={D} xla:", jax_out)
        assert re.search(rf"\[gather\] D={D} torch: .* rows/s", port_out)
        assert re.search(rf"\[gather\] D={D} kernel5: .* rows/s", port_out)
    assert "FAILED" not in port_out


def test_gather_probe_raises_on_a_kernel_mismatch(monkeypatch):
    """A kernel 5 result off by more than 1e-4 relative raises; the twin
    does not print ``FAILED`` and go on."""
    real = gather_probe.kernel_d2
    monkeypatch.setattr(gather_probe, "kernel_d2",
                        lambda e, q, c: real(e, q, c) * 1.001)
    with pytest.raises(AssertionError, match="kernel 5 mismatch"):
        gather_probe.main(["--corpus", "500", "--batch", "4", "--cand", "8",
                           "--dims", "8", "--reps", "1"] + CPU)


def test_transfer_probe_rows_and_product(run_jax, jit_outputs, capsys):
    """The JAX script's six rows, each also from pinned memory where a
    host buffer is involved; the whitening product on the same inputs
    within rtol 1e-5; every transfer exact."""
    run_jax("transfer_probe", [])
    jax_names = [line[:40].strip()
                 for line in capsys.readouterr().out.splitlines()]
    rec = transfer_probe.main(CPU)
    capsys.readouterr()
    assert len(jax_names) == 6
    assert set(jax_names) <= set(rec["rows"])
    assert len(rec["rows"]) == 10
    assert all(f"{n}, pinned" in rec["rows"] for n in jax_names
               if n.startswith(("h2d", "d2h")))
    np.testing.assert_allclose(rec["product_0"],
                               jit_outputs["<lambda>"][0],
                               rtol=1e-5, atol=1e-3)
    assert rec["transfers_exact"]


def test_probe_fused_epilogue_pool_equals_the_jax_served_pool(
        run_jax, monkeypatch, capsys):
    """Kernel 1's served pool (its plain version on the CPU) against the
    JAX script's served ``fused_query_topk`` on the same draws (exact on
    the CPU): the same ids but at ties; the library's folded and
    stripped forms timed beside it."""
    calls = []
    real = jindex.fused_query_topk

    def rec_call(*a, **k):
        out = real(*a, **k)
        calls.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jindex, "fused_query_topk", rec_call)
    args = ["--slots", "5000", "--dim", "8", "--batch", "16", "--k", "32"]
    run_jax("probe_fused_epilogue", args)
    jax_out = capsys.readouterr().out
    rec = probe_fused_epilogue.main(args + CPU)
    capsys.readouterr()
    assert "Sp=6144 D=8 B=16 k=32" in jax_out
    assert (rec["Sp"], rec["D"], rec["B"], rec["k"]) == (6144, 8, 16, 32)
    want = calls[0]
    assert want.shape == rec["served_ids"].shape == (16, 32)
    differ = sum(len(set(a) ^ set(b)) for a, b in zip(want.tolist(),
                                                     rec["served_ids"]
                                                     .tolist()))
    assert differ <= 2 * rec["tied_ids"]["served"] + 2
    assert set(rec["ms"]) == {"kernel_served", "kernel_folded",
                              "library_served", "library_folded",
                              "library_stripped"}
    assert rec["bound_ms"] <= rec["roofline_min_ms"]


# ------------------------------------------------ probes on a forest

LINE_RR = re.compile(r"P=\s*(\d+): pool_coverage=(\S+) "
                     r"raw_rerank_recall@10=(\S+)")


def test_raw_rerank_probe_equals_the_jax_script(small_hard, run_jax,
                                                capsys):
    """Coverage and recall at each pool within one query of the JAX
    script's; the twin re-ranks through kernel 5's plain version."""
    run_jax("raw_rerank_probe", [])
    want = LINE_RR.findall(capsys.readouterr().out)
    rec = raw_rerank_probe.main(CPU)
    got = LINE_RR.findall(capsys.readouterr().out)
    assert [g[0] for g in got] == [w[0] for w in want] == ["256", "1024",
                                                          "4096"]
    for g, w, r in zip(got, want, rec["pools"]):
        within_one_query(float(g[1]), float(w[1]), SMALL[1], g)
        within_one_query(float(g[2]), float(w[2]), SMALL[1], g)
        assert r["pool_coverage"] == pytest.approx(float(g[1]), abs=1e-4)


def lowered_thresholds(monkeypatch, blocked: int):
    """Both packages' indexes made with ``blocked_threshold`` and
    ``rerank_threshold`` at ``blocked``."""
    for mod in (jwrapper, twrapper):
        init = mod.CobwebIndex.__init__

        def made(self, *a, _init=init, **k):
            _init(self, *a, **k)
            self.blocked_threshold = self.rerank_threshold = blocked

        monkeypatch.setattr(mod.CobwebIndex, "__init__", made)


def test_rerank_stage_probe_equals_the_jax_script(small_hard, run_jax,
                                                  monkeypatch, capsys):
    """The four rows, in order; the twin's ``query_ids`` ids equal what
    its stages compose; its served recall within one query of the JAX
    script's ``query_ids`` on the same batch (recorded)."""
    lowered_thresholds(monkeypatch, 512)
    served = []
    real = jwrapper.CobwebIndex.query_ids

    def rec_ids(self, queries, k, **kw):
        out = real(self, queries, k, **kw)
        served.append((np.asarray(queries), np.asarray(out)))
        return out

    monkeypatch.setattr(jwrapper.CobwebIndex, "query_ids", rec_ids)
    run_jax("rerank_stage_probe", ["1024", "256"])
    jax_rows = [line[:34].strip()
                for line in capsys.readouterr().out.splitlines()]
    rec = rerank_stage_probe.main(["1024", "256"] + CPU)
    port_rows = [line[:34].strip()
                 for line in capsys.readouterr().out.splitlines()]
    assert len(jax_rows) == len(port_rows) == 4
    assert port_rows == list(rerank_stage_probe.ROWS)
    assert jax_rows[-1] == port_rows[-1] == "full query_ids"
    assert rec["stages_equal_query_ids"]
    data = tdatasets.synthetic_retrieval_hard(*SMALL)
    (q0, want), = [(q, ids) for q, ids in served
                   if len(q) == SMALL[1] and np.array_equal(
                       q, data.query_embs)][:1]
    within_one_query(recall(rec["served_ids"], data.target_ids),
                     recall(want, data.target_ids), SMALL[1])


# ------------------------------------------------------------- launcher

def test_launcher_maps_every_reference_script_to_its_twin():
    """Every ``scripts/*.py`` has a twin but the port's own three
    ``torch_*.py`` checks, which the launcher refuses; 28 twins in
    ``rag_cobweb_tpu_torch/scripts/``."""
    port_own = {"torch_multichip_phase", "torch_single_tree_recall",
                "torch_whitener_recall"}
    refused = set()
    for path in sorted((ROOT / "scripts").glob("*.py")):
        mod = launcher.twin_module(f"scripts/{path.name}")
        if mod is None:
            refused.add(path.stem)
            with pytest.raises(ValueError, match=path.name):
                launcher.experiment_command({"script":
                                             f"scripts/{path.name}"})
        else:
            assert importlib.util.find_spec(mod) is not None
            assert mod.rsplit(".", 1)[-1] == (
                "million" if path.stem == "million_benchmark" else path.stem)
    assert refused == port_own
    assert len({p.stem for p in (ROOT / "rag_cobweb_tpu_torch"
                                 / "scripts").glob("[!_]*.py")}) == 28


# the arguments a twin requires, where it has any
TWINS = [rerank_stage_probe, raw_rerank_probe, transfer_probe,
         probe_fused_epilogue, beam_microbench, gather_probe, pipeline_probe,
         ingress_rehearsal, run_8m]


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
@pytest.mark.parametrize("twin", TWINS,
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_probe_twins_refuse_the_host_by_default(twin, tmp_path,
                                                monkeypatch):
    """Without ``--device`` a twin asks for the card, and without one it
    raises before any work (no file written, none read)."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main(["--root", str(tmp_path / "r")]
                  if twin is ingress_rehearsal else [])
    assert not any(tmp_path.iterdir())
