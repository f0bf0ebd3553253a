"""Nothing of the benchmark imports JAX or the JAX package, compared by whole
top-level names (the port's name only begins with the JAX package's), and
nothing of it reads the JAX package's old harness."""

from __future__ import annotations

import ast
import subprocess
import sys
import types

import pytest

from bench_support import BENCH_DIR, ROOT

import run as bench_run

FORBIDDEN = {"jax", "jaxlib", "flax", "audio_pattern_detector_tpu"}
OLD_HARNESS = ("bench.py", "bench_results", "BENCH_r0", "MULTICHIP_r0")
SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def _imported_tops(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_source_imports_jax_or_the_jax_package(path) -> None:
    assert not (_imported_tops(path) & FORBIDDEN)
    text = path.read_text()
    assert not any(name in text for name in OLD_HARNESS if path.name != "test_bench_isolation.py")


def test_the_check_compares_whole_names(monkeypatch) -> None:
    before = bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "audio_pattern_detector_tpu_torch_probe", types.ModuleType("p"))
    monkeypatch.setitem(sys.modules, "jaxtyping_probe.sub", types.ModuleType("q"))
    assert bench_run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "audio_pattern_detector_tpu.models", types.ModuleType("r"))
    assert "audio_pattern_detector_tpu" in bench_run.forbidden_modules()


def test_a_cpu_run_loads_neither() -> None:
    """A smoke run of a cell in a fresh process whose import system refuses
    JAX and the JAX package; after it, no such module is loaded."""
    code = f"""
import importlib.abc, sys
FORBIDDEN = {sorted(FORBIDDEN)!r}
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("refused: " + name)
        return None
sys.meta_path.insert(0, Refuse())
sys.path[:0] = [{str(BENCH_DIR / 'tests')!r}, {str(BENCH_DIR)!r}, {str(ROOT)!r}]
from bench_support import tiny_cell
import run
result, _ = run.run_cell(tiny_cell("hk_radio.beeps"), 3, 0.3, False, "cpu")
assert result["correct"], result
tops = {{m.split(".")[0] for m in sys.modules}}
assert not (tops & set(FORBIDDEN)), tops & set(FORBIDDEN)
assert "audio_pattern_detector_tpu_torch" in tops
assert run.forbidden_modules() == []
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_a_forbidden_module_loaded_after_the_window_refuses_the_result(tmp_path) -> None:
    """A metric reader (read after the window, like the trace and the
    reference) that loads a forbidden name: the run names it, exits 3 and
    prints no result line."""
    stub = tmp_path / "stub"
    (stub / "flax").mkdir(parents=True)
    (stub / "flax" / "__init__.py").write_text("")
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "setup_s.py").write_text("def read(ctx):\n    return ctx.setup_s\n")
    (metrics / "live_p95_ms.py").write_text("import flax  # noqa: F401\n\n\ndef read(ctx):\n    return 1.0\n")
    code = f"""
import sys
sys.path[:0] = [{str(BENCH_DIR / 'tests')!r}, {str(BENCH_DIR)!r}, {str(ROOT)!r}]
from pathlib import Path
from bench_support import tiny_cell
import harness.cell, run
harness.cell.METRICS = Path({str(metrics)!r})
sys.path.insert(0, {str(stub)!r})
result, lines = run.run_cell(tiny_cell("flagship64.live16"), 3, 0.3, False, "cpu")
assert result["correct"], result
sys.exit(run.emit(result, lines))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 3, proc.stderr[-3000:]
    assert proc.stdout.strip() == ""
    assert "loaded by the run: flax" in proc.stderr


def test_emit_prints_the_result_last_when_nothing_forbidden_is_loaded(capsys, monkeypatch) -> None:
    monkeypatch.setattr(bench_run, "forbidden_modules", lambda: [])
    assert bench_run.emit({"correct": True}, ["check x: 0 (limit <= 0)"]) == 0
    out, err = capsys.readouterr()
    assert out.strip().splitlines()[-1] == '{"correct": true}'
    assert err.strip().splitlines()[-1] == "check x: 0 (limit <= 0)"
