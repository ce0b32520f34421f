"""Boundaries of the PyTorch port: it imports nothing of JAX or of the JAX
package, importing it builds nothing, and its entry points refuse to run
on the host unless asked to (``device="cpu"``)."""

import ast
import subprocess
from pathlib import Path

import pytest
import torch

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "rag_cobweb_tpu"}
PORT_FILES = sorted((ROOT / "rag_cobweb_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax(path):
    bad = sorted(set(imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_rank_entry_points_import_no_jax():
    """What a spawned rank of a multi-device run loads (``bench/multichip``
    with its launcher and dry run, ``bench/multichip_slice``, the tests'
    rank programs in ``tests/torch_ranks.py``), imported in a fresh
    interpreter, brings in nothing of JAX or of the JAX package."""
    import sys
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import rag_cobweb_tpu_torch.bench.multichip, "
            "rag_cobweb_tpu_torch.bench.multichip_slice, torch_ranks; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)}]; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    tree = ast.parse((ROOT / "tests" / "torch_ranks.py").read_text())
    assert not {a.name.split(".")[0] for node in ast.walk(tree)
                if isinstance(node, ast.Import) for a in node.names} \
        & FORBIDDEN


def test_import_and_host_path_build_nothing(monkeypatch):
    """No nvcc at import or on the host path: kernels build at the first
    CUDA call only."""
    def refuse(*a, **k):
        raise AssertionError(f"subprocess started: {a}")

    monkeypatch.setattr(subprocess, "Popen", refuse)
    import importlib
    for p in PORT_FILES[:-1]:
        mod = ".".join(p.relative_to(ROOT).with_suffix("").parts)
        importlib.import_module(mod.removesuffix(".__init__"))
    from rag_cobweb_tpu_torch.core.index import BlockedIndex, FusedIndex
    from rag_cobweb_tpu_torch.ops import (_build, blocked_topk, fused_topk,
                                          rerank)
    fused_topk.slab_topk(torch.ones((2, 4)), torch.ones((4, 2048)),
                         torch.zeros(2048), torch.ones(2048, dtype=bool), 3)
    fused_topk.slab_group_topk(torch.ones((2, 4)), torch.ones((4, 2048)),
                               torch.zeros(2048),
                               torch.ones(2048, dtype=bool), 2)
    fused_topk.fused_group_topk(
        FusedIndex(torch.ones((4, 2048)), torch.zeros(2048),
                   torch.ones(2048, dtype=bool)), torch.ones((2, 2)), 3)
    rerank.rerank_lp(torch.ones((3, 4)), torch.ones((2, 4)),
                     torch.zeros((2, 5), dtype=torch.int32),
                     torch.zeros((2, 5)), 1.0)
    bidx = BlockedIndex(torch.ones((2, 16, 4)), torch.zeros((2, 16, 4)),
                        torch.zeros((2, 16)), torch.ones((2, 16, 16)),
                        torch.ones((2, 16), dtype=bool),
                        torch.zeros((2, 16), dtype=torch.int32))
    blocked_topk.blocked_topk(bidx, torch.ones((3, 4)), 5)
    blocked_topk.blocked_topk_tiled(bidx, torch.ones((3, 4)), 5)
    assert not _build._libs


def test_entry_points_refuse_the_host_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import json
    from rag_cobweb_tpu_torch import interop
    from rag_cobweb_tpu_torch.bench.baselines import FlatIndex
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.tree import CobwebTree
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.parallel.vforest import VForest
    from rag_cobweb_tpu_torch.training import FactorVAE, VICRegWhitener
    cfg = TreeConfig(dim=4)
    tree = CobwebTree(cfg, device="cpu")
    for make in (lambda: CobwebTree(cfg), lambda: VForest(cfg),
                 lambda: CobwebIndex(config=cfg, n_subtrees=2),
                 lambda: CobwebIndex(config=cfg),
                 lambda: CobwebIndex.load_json(json.dumps(
                     {"tree": json.loads(tree.dump_json())})),
                 lambda: CobwebTree.load_json(tree.dump_json()),
                 lambda: interop.tree_from_numpy(tree.host_arrays(), cfg),
                 lambda: FlatIndex(torch.zeros((3, 4)).numpy()),
                 lambda: VICRegWhitener(4), lambda: FactorVAE(4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import sys
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("kernel", ["blocked_topk", "blocked_topk_f32",
                                    "fused_topk", "fused_topk_f32",
                                    "fused_group_topk",
                                    "fused_group_topk_f32", "rerank_l2"])
def test_kernel_ab_entries_are_bound(kernel):
    """Every kernel ``bench/kernel_ab.py`` times names a built source and
    a C entry with an argument list in ``_build._SIGNATURES``."""
    from rag_cobweb_tpu_torch.bench import kernel_ab
    from rag_cobweb_tpu_torch.ops import _build
    assert kernel in kernel_ab.KERNELS
    source = kernel_ab.SOURCE.get(kernel, kernel)
    assert source in _build.SOURCES
    assert kernel_ab.ENTRY[kernel] in _build._SIGNATURES[source]


def test_library_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """A kernel library is rebuilt when its source or a header beside it
    (``csrc/*.cuh``) changes, and only then."""
    from rag_cobweb_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    hdr = tmp_path / "h.cuh"
    hdr.write_text("// one\n")
    (tmp_path / "notes.txt").write_text("a")
    first = _build.digest(src)
    (tmp_path / "notes.txt").write_text("b")
    assert _build.digest(src) == first
    hdr.write_text("// two\n")
    assert _build.digest(src) != first
    assert _build.library_path("fused_topk").name.startswith("libfused_topk_")
    cmd = _build.nvcc_command(src, tmp_path / "k.so", "-DX")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-DX" in cmd
    assert cmd[-1] == str(src)
