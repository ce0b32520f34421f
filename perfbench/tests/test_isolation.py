"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's), and
the reference imports nothing of the port either."""

import ast
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "rag_cobweb_tpu"}
PORT = "rag_cobweb_tpu_torch"
# the yardstick: what computes the reference's answers and the counts
PLAIN = ("reference.py", "gen.py", "stats.py", "roofline.py", "trace.py")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = top_level_imports(f) & FORBIDDEN
        assert not bad, f"{f.relative_to(HERE)} imports {sorted(bad)}"


def test_the_whole_name_is_compared():
    # the port's own name is not the JAX package's
    assert PORT.split(".")[0] not in FORBIDDEN
    assert "rag_cobweb_tpu" in FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for name in PLAIN:
        got = top_level_imports(HERE / name)
        assert PORT not in got, f"{name} imports the port"
        assert got <= {"__future__", "typing", "numpy", "torch",
                       "statistics", "perfbench"}, (name, got)
    # and what it imports of the harness is plain too
    for name in PLAIN:
        tree = ast.parse((HERE / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == \
                    "perfbench":
                for a in node.names:
                    assert f"{a.name}.py" in PLAIN, (name, a.name)
