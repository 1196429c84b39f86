"""The port stands alone: it imports neither ``jax`` nor anything of the
JAX package ``repro``, and its entry points run on the card unless asked
otherwise — they raise, never drift to the CPU, when CUDA is missing."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|repro)(?:[.\s]|$)",
                       re.MULTILINE)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_port_file_imports_jax_or_the_reference():
    offenders = {str(p.relative_to(ROOT)): IMPORT_RE.findall(p.read_text())
                 for p in _port_files()}
    assert {k: v for k, v in offenders.items() if v} == {}


def test_port_imports_with_jax_and_the_reference_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m, mod in sys.modules.items() if mod is not None)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20          # every submodule imported


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models.gdm import init_gdm, make_schedule
    from repro_torch.serving import GDMService, make_gdm_services
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("gdm-dit").reduced()
    for call in (GDMService, lambda: make_gdm_services(1),
                 lambda: init_gdm(cfg), lambda: make_schedule(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    # the library is named by its sources: both kernels, built for sm_90a
    assert [p.name for p in build._sources()] == ["adaln_norm.cu",
                                                  "flash_attention.cu"]
    assert "arch=compute_90a,code=sm_90a" in build.ARCH
    assert build.library_path().parent == ROOT / "build" / "kernels"
