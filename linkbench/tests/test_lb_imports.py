"""Nothing under linkbench/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the port. The command refuses to run
without a card, and in a directory that holds only the benchmark."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
SOURCES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "sdr_tpu"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_nor_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert "sdr_tpu_torch" not in names and not names & FORBIDDEN
    assert "sdr_tpu_torch" not in path.read_text()


def test_whole_names_are_compared():
    """``sdr_tpu_torch`` starts with ``sdr_tpu`` and is allowed; ``sdr_tpu`` is not."""
    from linkbench.harness.runner import FORBIDDEN as RUN_FORBIDDEN
    assert "sdr_tpu_torch" not in RUN_FORBIDDEN and "sdr_tpu" in RUN_FORBIDDEN
    assert "sdr_tpu_torch".split(".")[0] not in FORBIDDEN


def _run(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, whatever the machine holds
    return subprocess.run([sys.executable, "linkbench/run.py", "--workload",
                           "fast-config2-multipath", "--seed", "5", "--seconds", "1", "--trace",
                           "0", *extra], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def _has_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except ValueError:
            pass
    return False


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and not _has_result(out.stdout)
    assert "CUDA" in out.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "linkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and not _has_result(out.stdout)
