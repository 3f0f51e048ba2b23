"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module name (the port's ``repro_torch`` begins with the
JAX package's ``repro``), and the plain references import nothing of the
program."""

import ast
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _sources(sub=""):
    return sorted(p for p in (PKG / sub).rglob("*.py")
                  if "tests" not in p.relative_to(PKG).parts)


def test_no_jax_anywhere():
    found = {(str(p.relative_to(PKG)), m) for p in _sources()
             for m in _imports(p) if m.split(".")[0] in FORBIDDEN}
    assert not found


def test_references_import_nothing_of_the_program():
    refs = _sources("reference")
    assert refs
    for p in refs:
        tops = {m.split(".")[0] for m in _imports(p)}
        assert tops <= {"__future__", "typing", "numpy", "torch"}, p


def test_the_runtime_guard_compares_whole_names():
    from portbench import run

    assert run.forbidden_modules(["repro_torch", "repro_torch.serving",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["repro.models", "jax._src.core",
                                  "flax"]) == ["flax", "jax", "repro"]
