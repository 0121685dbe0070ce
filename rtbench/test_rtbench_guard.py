"""The import guard, and what the benchmark's sources import."""

import ast
import pathlib

import pytest

from rtbench import run

HERE = pathlib.Path(__file__).resolve().parent


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("modules,found", [
    (["raytracerfacility_tpu_torch", "raytracerfacility_tpu_torch.ops.seg", "torch"], []),
    (["raytracerfacility_tpu.models", "torch"], ["raytracerfacility_tpu"]),
    (["jax", "jax.numpy", "flax.linen"], ["flax", "jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["jaxtyping", "flaxy"], []),
])
def test_forbidden_names_compare_whole(modules, found):
    assert run.forbidden_modules(dict.fromkeys(modules)) == found


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        names = set(_imports(path))
        assert "raytracerfacility_tpu_torch" not in names, path
        assert not names & set(run.FORBIDDEN), path


def test_nothing_under_the_benchmark_imports_jax():
    for path in HERE.rglob("*.py"):
        assert not set(_imports(path)) & set(run.FORBIDDEN), path


def test_no_result_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        run.main(["--workload", "cfg2.progressive_1080p", "--seed", "1",
                  "--seconds", "1"])
    assert err.value.code not in (0, None)
    assert capsys.readouterr().out == ""
