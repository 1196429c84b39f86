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
        "print(' '.join(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 66                       # every submodule imported
    # the closed loop's modules among them, the fused engine's and the
    # fleet layer's
    assert {f"repro_torch.{m}" for m in (
        "experiments", "core.baselines", "core.constraints", "core.learn_gdm",
        "core.mac", "core.policy", "nn.recurrent", "rl.d3ql", "rl.networks",
        "rl.replay", "sim.vec_env", "sim.workloads", "sim.torch_env",
        "sim.faults", "serving.scheduler", "serving.cluster")} <= names


def test_entry_points_raise_without_cuda(monkeypatch):
    import dataclasses
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch import serve, train
    from repro_torch.models.gdm import init_gdm, make_schedule
    from repro_torch.models.lm import init_decode_state, init_lm
    from repro_torch import experiments
    from repro_torch.core import LearnGDMController
    from repro_torch.rl import D3QLAgent, D3QLConfig, qnet_init
    from repro_torch.serving import GDMService, make_gdm_services
    from repro_torch.core.policy import GreedyPoAPolicy, evaluate_fused
    from repro_torch.sim import EdgeSimulator, get_scenario, torch_env
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    smoke = get_scenario("smoke")
    cfg = get_config("gdm-dit").reduced()
    lm_cfg = get_config("yi-6b").reduced()
    jamba = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(),
                                num_experts=0)
    for call in (GDMService, lambda: make_gdm_services(1),
                 lambda: init_gdm(cfg), lambda: make_schedule(4),
                 lambda: init_lm(lm_cfg),
                 lambda: init_decode_state(lm_cfg, 1, 8),
                 lambda: serve.run(requests=1), lambda: serve.main([]),
                 lambda: init_lm(jamba),
                 lambda: init_decode_state(jamba, 1, 8),
                 lambda: train.run(jamba, TrainConfig(total_steps=1)),
                 lambda: train.main(["--steps", "1"]),
                 lambda: D3QLAgent(D3QLConfig()), lambda: qnet_init(8, 2, 3),
                 lambda: LearnGDMController(EdgeSimulator(smoke)),
                 lambda: experiments.train_variant(smoke, "learn-gdm", 1),
                 lambda: experiments.run_suite(smoke, train_eps=1,
                                               eval_eps=1),
                 lambda: experiments.serve_variant(smoke, train_eps=1,
                                                   frames=1),
                 lambda: experiments.serve_fleet_variant(
                     smoke, train_eps=1, frames=1, cells=2),
                 lambda: torch_env.world_from_sim(EdgeSimulator(smoke), 2),
                 lambda: evaluate_fused(GreedyPoAPolicy(),
                                        EdgeSimulator(smoke), 1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    # the library is named by its sources: every kernel, built for sm_90a
    assert [p.name for p in build._sources()] == [
        "adaln_norm.cu", "decode_attention.cu", "flash_attention.cu",
        "rmsnorm.cu", "ssm_scan.cu", "ssm_scan_backward.cu"]
    assert [p.name for p in build._headers()] == ["ssm_scan.cuh"]
    assert {n[:-len("_f32")] for n in build.SIGNATURES} <= {
        p.stem for p in build._sources()}
    assert "arch=compute_90a,code=sm_90a" in build.ARCH
    assert build.library_path().parent == ROOT / "build" / "kernels"
