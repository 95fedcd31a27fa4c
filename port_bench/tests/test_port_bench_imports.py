"""Nothing under port_bench imports JAX or the JAX package (each import's
top-level name compared whole: ``dreamlab_tpu_torch`` begins with
``dreamlab_tpu``), and the reference and the yardstick import nothing of
the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FILES = sorted(p for p in HERE.rglob("*.py") if "_cache" not in p.parts)
# the yardstick: reference, weights, traffic, operation counts, decoder, checks
PLAIN = ("reference.py", "weights.py", "sd_arch.py", "vocab.py", "traffic.py", "flops.py",
         "pngdec.py", "checks.py", "client.py", "readers.py", "trace.py")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "dreamlab_tpu"}


@pytest.mark.parametrize("name", PLAIN)
def test_the_yardstick_imports_nothing_of_the_program(name):
    assert "dreamlab_tpu_torch" not in top_level_imports(HERE / name)


def test_the_load_generator_does_not_import_torch():
    assert "torch" not in top_level_imports(HERE / "client.py") | top_level_imports(
        HERE / "traffic.py") | top_level_imports(HERE / "vocab.py")
