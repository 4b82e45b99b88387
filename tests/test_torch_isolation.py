"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and
no quiet fall back to the CPU when a card was asked for.

An AST scan holds every module of ``src/repro_torch`` and ``chip_smoke.py``
to imports of neither ``jax`` nor ``repro``; a subprocess imports every
module of the port with both blocked; the driver's default device raises
on a host without a card; and ``chip_smoke.py`` fails without one.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import resolve_device
from repro_torch.launch import serve as tserve

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    """Top-level package of every import statement in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_and_reference_blocked():
    mods = sorted(".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("")
                           .parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "loaded = [k for k, v in sys.modules.items() if v is not None]\n"
        "assert not [k for k in loaded if k.split('.')[0] in\n"
        "            ('jax', 'jaxlib', 'repro', 'triton')], loaded\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--reduced", "--quiet"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_a_card_and_outside_the_repo(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True,
                             text=True, env=env, cwd=script.parent, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
