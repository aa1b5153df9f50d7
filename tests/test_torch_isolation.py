"""heat_tpu_torch stands alone: it and chip_smoke.py import neither JAX
nor anything of heat_tpu, and importing them runs nothing."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "heat_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_PROBE = r"""
import importlib.util, json, sys
import heat_tpu_torch as ht
spec = importlib.util.spec_from_file_location("chip_smoke_probe", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m in ("jax", "jaxlib") or m.startswith(("jax.", "jaxlib.", "heat_tpu.")) or m == "heat_tpu")
print(json.dumps({"bad": bad, "device": str(ht.get_device())}))
"""


def test_import_loads_no_jax_and_defaults_to_gpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout  # importing chip_smoke prints nothing
    report = json.loads(lines[0])
    assert report == {"bad": [], "device": "gpu:0"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_sources_import_no_jax_and_no_heat_tpu(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "heat_tpu"), f"{path.name} imports {name}"
