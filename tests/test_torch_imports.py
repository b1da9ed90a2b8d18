"""The port stands alone: no JAX, no ss_asr_tpu, no hidden fallbacks.

* Every ``ss_asr_tpu_torch`` module, and ``chip_smoke`` as a module, imports
  in a process where ``import jax`` fails, and loads neither ``jax`` nor
  ``ss_asr_tpu``.
* The kernel build raises a clear error without ``nvcc``.
* No kernel wrapper catches an exception around its launch.
* The CLIs refuse to run on the CPU when asked for CUDA that is absent.
"""

import ast
import inspect
import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import ss_asr_tpu_torch
from ss_asr_tpu_torch.ops.kernels import build
from ss_asr_tpu_torch.ops.kernels import decode as kdecode
from ss_asr_tpu_torch.ops.kernels import lstm as klstm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(ss_asr_tpu_torch.__path__,
                                                          "ss_asr_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _modules() + ["chip_smoke"]
    assert "ss_asr_tpu_torch.ops.kernels.decode" in mods and len(mods) > 15
    code = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m, v in sys.modules.items() if v is not None and (\n"
        "      m.split('.')[0] in ('jax', 'jaxlib', 'ss_asr_tpu')))))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert loaded == [], loaded


def test_sources_never_import_jax_or_the_jax_package():
    files = list((ROOT / "ss_asr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "ss_asr_tpu"), f"{f}: imports {n}"


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "_torch_cuda_home", lambda: None)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build_library(tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_library_name_follows_the_sources(tmp_path):
    a = build.library_path(tmp_path)
    assert a == build.library_path(tmp_path) and a.parent == tmp_path
    assert a.name.startswith("libss_asr_kernels_") and a.suffix == ".so"
    assert {s.name for s in build.sources()} >= {"lstm_fwd.cu", "greedy_decode.cu"}
    # every C entry point the wrappers call has its signature declared
    called = set()
    for fn in (klstm.lstm_fwd, kdecode.greedy_decode):
        called |= set(re.findall(r"lib\.(ss_\w+)\(", inspect.getsource(fn)))
    assert called == set(build.SIGNATURES)


@pytest.mark.parametrize("fn", [klstm.lstm_fwd, kdecode.greedy_decode],
                         ids=["lstm_fwd", "greedy_decode"])
def test_kernel_wrappers_hold_no_try(fn):
    tree = ast.parse(inspect.getsource(fn).lstrip())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    assert "load_library" in inspect.getsource(fn)


@pytest.mark.parametrize("cli", ["serve", "transcribe"])
def test_cli_refuses_missing_cuda(cli, monkeypatch):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"ss_asr_tpu_torch.cli.{cli}")
    argv = ["asr.npz"] + (["u.wav"] if cli == "transcribe" else [])
    with pytest.raises(SystemExit, match="CUDA is not available"):
        mod.main(argv)


def test_from_checkpoint_refuses_missing_cuda(monkeypatch):
    from ss_asr_tpu_torch.api import Transcriber

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transcriber.from_checkpoint("asr.npz", device="cuda")


def test_chip_smoke_fails_without_cuda():
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
