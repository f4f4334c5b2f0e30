"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name; the reference imports nothing of the program; the
harness refuses to measure without a card."""
import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from chipbench import run

HERE = pathlib.Path(__file__).resolve().parent


def imported(path: pathlib.Path) -> set[str]:
    """Top-level names of the modules a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_and_no_program_in_the_reference(path):
    names = imported(path)
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names
    if path.parent.name == "ref":
        assert "repro_torch" not in names, names


def test_the_check_compares_whole_top_level_names():
    ok = ["repro_torch", "repro_torch.kernels.ops", "torch", "jax_like",
          "reprox", "chipbench.run"]
    assert run.forbidden_modules(ok) == []
    assert run.forbidden_modules(ok + ["repro.core.lov", "jaxlib.xla",
                                       "flax", "jax"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_no_result_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    assert run.main(["--workload", "phi35moe.prefill_chat", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's folder
    has no program to run: non-zero, nothing on standard output."""
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, *spec["command"][1:], "--workload",
                        "phi35moe.ckpt_rank", "--seed", "3", "--seconds",
                        "1"], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
