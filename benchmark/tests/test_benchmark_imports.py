"""What the benchmark may import: no module under benchmark/ names jax,
jaxlib, flax or the JAX package as its top-level module (whole names:
the port's nspeech_tpu_torch passes), and the references import nothing
of the program. A run without a card exits 1 with no result."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import core
from benchmark.harness.runner import FORBIDDEN

FILES = sorted(core.BENCH.rglob("*.py"))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(core.BENCH)))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((core.BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "nspeech_tpu_torch" not in set(_imports(path))


def test_run_without_a_card_exits_1_and_prints_no_result():
    proc = subprocess.run([sys.executable, str(core.BENCH / "run.py"), "--workload",
                           "t2wn.stream", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=core.ROOT,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 1 and proc.stdout.strip() == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_forbidden_names_compare_whole_top_level_names():
    from benchmark.harness import runner
    sys.modules.setdefault("nspeech_tpu_torch_probe", sys)
    assert "nspeech_tpu_torch_probe" not in runner.forbidden_modules()
