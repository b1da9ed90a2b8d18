"""Build and load the CUDA kernels of ``ss_asr_tpu_torch/csrc``.

At first use, every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
the objects are linked into ONE shared library with a plain C interface,
which is loaded with ``ctypes``.  No PyTorch headers are included, so the build takes
seconds, not the minutes a ``torch.utils.cpp_extension`` build takes.

The library lands in ``ss_asr_tpu_torch/_build/`` (git-ignored), named by a
hash of the sources and flags: an edited source builds a new library, an
unchanged one is reused.  Delete that directory to force a rebuild.

Importing this module needs neither ``nvcc`` nor a GPU; a missing ``nvcc``
or a failed compile raises ``KernelBuildError`` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int

#: C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    # gx, whh, lengths, y, cs, D, T, B, H, rev_bits, cluster, rows, device,
    # stream
    "ss_lstm_fwd": [_P] * 5 + [_I] * 4 + [ctypes.c_uint, _I, _I, _I, _P],
    # H, cluster, rows, device, resident (int*)
    "ss_lstm_fwd_resident_clusters": [_I, _I, _I, _I, _P],
    # gx, whh, lengths, y, cs, dy, dgx, D, T, B, H, rev_bits, cluster, rows,
    # device, stream
    "ss_lstm_bwd": [_P] * 7 + [_I] * 4 + [ctypes.c_uint, _I, _I, _I, _P],
    # H, cluster, rows, device, resident (int*)
    "ss_lstm_bwd_resident_clusters": [_I, _I, _I, _I, _P],
    # enc, comp, lens, phi, wih1, whh1, b1, wih2, whh2, b2, ct_w, ct_b, emb,
    # out, B, S, F, M, H, V, max_steps, rows, device, stream
    "ss_greedy_decode": [_P] * 14 + [_I] * 9 + [_P],
    # ... the same up to max_steps, then lm_emb, g1 (wih, whh, bih, bhh), g2
    # (...), lm_w, lm_b, HL, lm_weight, rows, device, stream
    "ss_greedy_decode_lm": [_P] * 14 + [_I] * 7 + [_P] * 11 + [_I, ctypes.c_float, _I, _I, _P],
    # enc, comp, lens, the 10 speller weights, toks, parents, scores, done,
    # hyp_len, att (scratch), B, S, F, M, H, V, K, max_steps, device, stream
    "ss_beam_decode": [_P] * 19 + [_I] * 8 + [_I, _P],
    # ... the same up to max_steps, then the 11 LM weights, HL, lm_weight,
    # device, stream
    "ss_beam_decode_lm": [_P] * 19 + [_I] * 8 + [_P] * 11 + [_I, ctypes.c_float, _I, _P],
    # the same as ss_beam_decode_lm (the LM's pointers null without one), then
    # the packed weight stream, cluster, utterances a cluster, device, stream
    "ss_beam_decode_cluster": [_P] * 19 + [_I] * 8 + [_P] * 11 + [_I, ctypes.c_float, _P, _I, _I,
                                                                  _I, _P],
    # H, F, M, V, HL, S, K, cluster, utterances a cluster, device, out (int[3]: floats,
    # attention in shared memory, ring stages)
    "ss_beam_cluster_plan": [_I] * 10 + [_P],
    # enc, comp, lens, tf, gumbel, teacher_emb, the 10 speller weights,
    # logits, a, h1s, c1s, h2s, c2s, fed, g1s, g2s, B, S, F, M, H, V, L, rows,
    # device, stream
    "ss_spell_fwd": [_P] * 25 + [_I] * 8 + [_I, _P],
    # enc, comp, dlogits, daext, a, h1s, c1s, h2s, c2s, fed, the speller
    # weights less ct_b, g1s, g2s, wt1, wt2, dg1, dg2, de, dqp, demb, B, S, F,
    # M, H, V, L, rows, device, stream
    "ss_spell_bwd": [_P] * 28 + [_I] * 8 + [_I, _P],
    # yp, wbasis_il, mel, out, B, Np, nf, n_fft, hop, n_bins, kpad, ncols,
    # n_mels, log_eps, device, stream
    "ss_fbank": [_P] * 4 + [_I] * 9 + [ctypes.c_float, _I, _P],
}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or the kernels failed to compile or load."""


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_count_lock = threading.Lock()


def count_launch(launches: Dict[str, int], name: str) -> None:
    """Add one to a wrapper's launch counter.  Wrappers launch from several
    threads at once (a server's batcher and its request handlers), and a
    dict item's ``+=`` is not atomic."""
    with _count_lock:
        launches[name] += 1


def _torch_cuda_home() -> Optional[str]:
    from torch.utils.cpp_extension import CUDA_HOME

    return CUDA_HOME


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, PyTorch's CUDA toolkit lookup, or $PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or _torch_cuda_home()
    if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, the CUDA toolkit PyTorch "
        "detects, and $PATH): the CUDA kernels of ss_asr_tpu_torch are "
        "compiled at first use and need the CUDA toolkit; CPU tensors use "
        "the plain PyTorch versions and need no build"
    )


def sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return Path(build_dir) / f"libss_asr_kernels_{h.hexdigest()[:16]}.so"


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``csrc/*.cu`` into the hashed library unless it exists."""
    out = library_path(build_dir)
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        cu = [s for s in sources() if s.suffix == ".cu"]
        objs = [os.path.join(tmp, s.stem + ".o") for s in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)] for s, o in zip(cu, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        link = [nvcc, *LINK_FLAGS, "-o", os.path.join(tmp, out.name), *objs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(link)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(os.path.join(tmp, out.name), out)
    return out


def load_library() -> ctypes.CDLL:
    """Build on first use, load once per process, declare every signature."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ss_error_string.argtypes = [ctypes.c_int]
            lib.ss_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = load_library().ss_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")
