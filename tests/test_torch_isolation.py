"""The port stands alone: no JAX and nothing of the reference package.

``repro_torch`` and ``chip_smoke.py`` must run on a machine without JAX,
so they import neither ``jax`` nor ``repro``; input reaches the card unless
the caller names the CPU.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path} imports {bad}"


def test_port_runs_with_jax_blocked():
    """In a fresh interpreter where ``import jax`` fails, the whole port
    imports (``core.robust`` included) and answers a CPU median and a CPU
    segmented solve, and no ``repro`` module loads."""
    code = """
import sys
sys.modules["jax"] = None
import numpy as np
import repro_torch
import repro_torch.kernels._build, repro_torch.kernels.cp_objective
import repro_torch.kernels.ops, repro_torch.kernels.ref
import repro_torch.core.robust
from repro_torch.convert import from_numpy
from repro_torch.core import selection
x = from_numpy(np.arange(9, dtype=np.float32)[::-1].copy(), device="cpu")
assert float(selection.median(x).value) == 4.0
assert selection.quantiles(x, [0.5, 1.0]).value.tolist() == [4.0, 8.0]
seg = from_numpy(np.arange(9, dtype=np.int32) % 2, device="cpu")
res = selection.segmented_order_statistic(x, seg, [1, 4], nsegs=2)
assert res.value.tolist() == [0.0, 7.0], res
loaded = [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
assert not loaded, loaded
print("ok")
"""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_from_numpy_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.from_numpy(np.zeros(3, np.float32))
    t = convert.from_numpy(np.arange(3, dtype=np.float32), device="cpu")
    assert t.device.type == "cpu" and t.dtype == torch.float32
