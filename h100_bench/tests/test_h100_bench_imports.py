"""The import check, and what the benchmark's own files import."""
import ast
from pathlib import Path

from h100_bench.bench.common import ROOT, forbidden_modules


def test_forbidden_by_whole_top_level_name():
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client",
                              "flax.linen", "bigdl_tpu",
                              "bigdl_tpu.serving"]) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "bigdl_tpu", "bigdl_tpu.serving"])
    assert forbidden_modules(["bigdl_tpu_torch", "bigdl_tpu_torch.serving",
                              "jaxtyping", "flaxen", "torch",
                              "numpy"]) == []


def imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "h100_bench").rglob("*.py"):
        assert forbidden_modules(imports(path)) == [], path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "h100_bench" / "reference").rglob("*.py"):
        for name in imports(path):
            assert name.split(".")[0] != "bigdl_tpu_torch", path
