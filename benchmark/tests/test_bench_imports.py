"""What a run may load: no module whose top-level name is jax, jaxlib,
flax or the JAX package (compared whole: the port's name begins with the
JAX package's); the reference imports nothing of the port; nothing of
the benchmark reads the JAX package's benchmark files."""
import ast
import subprocess
import sys

import pytest

import harness
from conftest import BENCH, ROOT


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "psdr_jit_tpu_torch_x", sys)
    monkeypatch.delitem(sys.modules, "psdr_jit_tpu", raising=False)
    assert "psdr_jit_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "psdr_jit_tpu.ops", sys)
    assert "psdr_jit_tpu" in harness.forbidden_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_sources(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN)
    if "reference" in path.relative_to(BENCH).parts:
        assert "psdr_jit_tpu_torch" not in tops


def test_nothing_reads_the_jax_benchmark():
    for path in BENCH.rglob("*.py"):
        if path.name == "test_bench_imports.py":
            continue
        text = path.read_text()
        assert "BENCH_r0" not in text and "MULTICHIP_r0" not in text, path
        assert "bench" not in {m.split(".")[0] for m in _imports(path)}, path


def test_reference_loads_alone():
    code = ("import sys; sys.path.insert(0, %r); import reference; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'psdr_jit_tpu', "
            "'psdr_jit_tpu_torch')); print(bad); sys.exit(1 if bad else 0)"
            % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_run_without_a_card_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "cbox.frame",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
