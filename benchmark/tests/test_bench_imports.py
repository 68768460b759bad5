"""Nothing of JAX or the JAX package, and a reference independent of the
program."""

import ast
import glob
import os
import sys

from benchmark import run
from benchmark.lib import cells


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "versband_tpu_torch_like", object())
    assert "versband_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "versband_tpu.models", object())
    assert "versband_tpu" in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert "jaxlib" in run.forbidden_modules()


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_file_imports_jax():
    for path in glob.glob(os.path.join(cells.BENCH, "**", "*.py"), recursive=True):
        assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "versband_tpu"}, path


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(cells.BENCH, "reference", "*.py")):
        assert "versband_tpu_torch" not in set(_imports(path)), path
        text = open(path).read()
        assert "benchmark.lib" not in text and "benchmark.drivers" not in text, path


def test_run_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        return
    rc = run.main(["--workload", "accomp_band.serve", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""
