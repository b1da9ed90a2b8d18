"""Time the speller kernels, K9 and K10 (the attend-and-spell forward and
backward) and K6 / K7 (the greedy decode ± char-LM), on every route, and
break their cluster routes' steps into phases, on the card.

    python -m ss_asr_tpu_torch.ops.kernels.spell_probe            # K9 / K10 route table
    python -m ss_asr_tpu_torch.ops.kernels.spell_probe --greedy   # K6 / K7 route table
    python -m ss_asr_tpu_torch.ops.kernels.spell_probe --trace    # cycles a step

The route tables: the cluster route at each tile height and the one-row
kernels, CUDA-event medians of 7 calls after a warm-up, on seeded random
weights at the flagship width. K9 / K10 at the ASR step's shape (B = 32, L =
48, S = 64), the TAE step's (B = 64, S = 48) and the alignment pass's (B =
16, L = 16), with each route's largest difference from the plain versions;
K6 / K7 at B = 1, 8, 16, 32 and 64, S = 64, over all 200 steps (an EOS bias of
-50 keeps every row decoding), with each route's rows whose tokens differ
from the plain decode's.

The trace builds an instrumented copy of ``csrc/`` in a temporary
directory: before each statement of the cluster kernels' step loop, thread
0 of the first CTA adds the ``clock64`` cycles since the previous mark to a
device array, read back after 5 calls at the ASR step's shape (K6 / K7:
B = 16, S = 64, 200 steps, without and with the LM).  A mark
costs a few hundred cycles itself (a read-modify-write of device memory),
so the phases' sum exceeds the untraced step.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from ss_asr_tpu_torch.models import charlm, las
from ss_asr_tpu_torch.ops.kernels import build
from ss_asr_tpu_torch.ops.kernels import decode as kd
from ss_asr_tpu_torch.ops.kernels import spell as ks
from ss_asr_tpu_torch.ops.kernels.decode import speller_weights
from ss_asr_tpu_torch.vocab import EOS_ID, VOCAB_SIZE

SHAPES = ((32, 64, 48), (64, 48, 48), (16, 64, 16))  # (B, S, L)
GREEDY_BATCHES = (1, 8, 16, 32, 64)
GREEDY_S = 64
GREEDY_STEPS = 200
TRACE_REPS = 5


def cuda_ms(fn, reps: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def inputs(model, B: int, S: int, L: int, seed: int = 0):
    """Seeded listener-like memory, lengths, draws at tf 0.9 and cotangents."""
    dev = next(model.parameters()).device
    g = torch.Generator().manual_seed(seed)
    enc = (torch.randn(B, S, model.cfg.enc_out_dim, generator=g) * 0.5).to(dev)
    lens = torch.randint(1, S + 1, (B,), generator=g, dtype=torch.int32).to(dev)
    tf = (torch.rand(L, generator=g) < 0.9).float().to(dev)
    gumbel = -torch.log(-torch.log(torch.rand(L, B, VOCAB_SIZE, generator=g))).to(dev)
    ids = torch.randint(0, VOCAB_SIZE, (L, B), generator=g).to(dev)
    dlogits = (torch.randn(L, B, VOCAB_SIZE, generator=g) / B).to(dev)
    daext = (torch.randn(L, B, S, generator=g) / B).to(dev)
    with torch.no_grad():
        comp = las.attention_precompute(model.attention, enc)
        temb = model.embed.weight[ids]
    return (model, enc, comp, lens, tf, gumbel, temb), dlogits, daext


def route_table(model) -> None:
    W = [w.detach() for w in speller_weights(model)]
    for B, S, L in SHAPES:
        args, dl, da = inputs(model, B, S, L)
        enc, comp = args[1], args[2]
        with torch.no_grad():
            out = ks.spell_fwd(*args, with_gates=True)
            want_f = ks.spell_fwd_plain(*args)
            want_b = ks.spell_bwd_plain(enc, comp, dl, da, out[1:7], W)
            by_shape = ks.spell_route(B, model.cfg.decoder_state_size, enc.shape[2],
                                      model.cfg.mlp_out_size, S, VOCAB_SIZE)
            cells = []
            for R in ks.TILE_ROWS + (0,):
                f = ks.spell_fwd(*args, with_gates=bool(R), route=R)
                gates = f[7:] if R else None
                b = ks.spell_bwd(enc, comp, dl, da, f[1:7], W, gates, route=R)
                err = max(float((x - y).abs().max()) for x, y in zip(f[:7], want_f))
                err_b = max(float((x - y).abs().max()) for x, y in zip(b, want_b))
                f_ms = cuda_ms(lambda: ks.spell_fwd(*args, with_gates=bool(R), route=R))
                b_ms = cuda_ms(lambda: ks.spell_bwd(enc, comp, dl, da, f[1:7], W, gates, route=R))
                cells.append(f"R={R}{'*' if R == by_shape else ''} K9 {f_ms:.3f} ms "
                             f"(err {err:.1e}) K10 {b_ms:.3f} ms (err {err_b:.1e})")
        print(f"B={B} S={S} L={L}: " + "; ".join(cells), flush=True)


def greedy_models():
    """The flagship speller and char-LM on seeded random weights, the
    speller's EOS logit biased by -50 so that every row decodes all steps."""
    torch.manual_seed(0)
    model = las.LAS(las.ASRConfig()).cuda().eval()
    lm = charlm.CharLM(charlm.CharLMConfig()).cuda().eval()
    with torch.no_grad():
        model.char_trans.bias[EOS_ID] = -50.0
    return model, lm


def greedy_inputs(model, B: int):
    dev = next(model.parameters()).device
    g = torch.Generator().manual_seed(B)
    enc = (torch.randn(B, GREEDY_S, model.cfg.enc_out_dim, generator=g) * 0.5).to(dev)
    lens = torch.randint(1, GREEDY_S + 1, (B,), generator=g, dtype=torch.int32).to(dev)
    with torch.no_grad():
        comp = las.attention_precompute(model.attention, enc)
    return enc, comp, lens


def greedy_table(model, lm) -> None:
    cfg = model.cfg
    for B in GREEDY_BATCHES:
        mem = greedy_inputs(model, B)
        for lm_ in (None, lm):
            HL = lm_.cfg.hidden_size if lm_ is not None else 0
            by_shape = kd.greedy_route(B, cfg.decoder_state_size, cfg.enc_out_dim,
                                       cfg.mlp_out_size, GREEDY_S, VOCAB_SIZE, HL)
            routes = [R for R in kd.GREEDY_TILE_ROWS if kd.greedy_cluster_serves(
                cfg.decoder_state_size, cfg.enc_out_dim, cfg.mlp_out_size, GREEDY_S, VOCAB_SIZE,
                HL, R)] + [0]
            cells = []
            with torch.inference_mode():
                want = kd.greedy_decode_plain(model, *mem, GREEDY_STEPS, lm_, 0.5)
                for R in routes:
                    got = kd.greedy_decode(model, *mem, GREEDY_STEPS, lm_, 0.5, route=R)
                    rows = int((got != want).any(1).sum())
                    ms = cuda_ms(lambda: kd.greedy_decode(model, *mem, GREEDY_STEPS, lm_, 0.5,
                                                          route=R))
                    cells.append(f"R={R}{'*' if R == by_shape else ''} {ms:.3f} ms "
                                 f"({1e3 * ms / GREEDY_STEPS:.1f} us/step, {rows} rows differ)")
            print(f"greedy{'+lm' if lm_ is not None else ''} B={B} S={GREEDY_S} "
                  f"{GREEDY_STEPS} steps: " + "; ".join(cells), flush=True)


#: the step loops the trace instruments: name -> (source, the loop's first line)
TRACED_LOOPS = {"fwd": ("spell_fwd.cu", "  for (int t = 0; t < p.L; ++t) {"),
                "bwd": ("spell_bwd.cu", "  for (int t = p.L - 1; t >= 0; --t) {"),
                "greedy": ("greedy_decode.cu", "  for (int t = 0; t < T; ++t) {")}


def instrumented_sources(dst: Path) -> dict:
    """A copy of csrc/ whose cluster kernels mark every statement of their
    step loop -> {(kernel, mark): source line}."""
    for f in build.CSRC_DIR.iterdir():
        shutil.copy(f, dst / f.name)
    labels = {}
    for name, (fname, loop) in TRACED_LOOPS.items():
        src = (dst / fname).read_text().split("\n")
        start = max(i for i, line in enumerate(src) if line == loop)  # the cluster kernel's
        end = next(i for i in range(start + 1, len(src)) if src[i] == "  }")
        out, n = [], 0
        for i, line in enumerate(src):
            if (start < i <= end and (re.match(r"    [a-zA-Z]", line) or i == end)
                    and not src[i - 1].startswith("#pragma")):
                n += 1
                labels[(name, n)] = f"{i + 1}: {line.strip()[:72]}"
                out.append(f"    SP_MARK({n});")
            out.append(line)
            if i == start:
                out.append("    long long sp_last = clock64();")
        text = "\n".join(out).replace('#include "speller.cuh"', f'''#include "speller.cuh"
__device__ long long g_sp_trace_{name}[128];
#define SP_MARK(i) if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {{ \\
  long long now = clock64(); g_sp_trace_{name}[i] += now - sp_last; sp_last = now; }}
extern "C" int ss_sp_trace_{name}(long long* out, int reset) {{
  static long long zero[128] = {{0}};
  if (reset) return cudaMemcpyToSymbol(g_sp_trace_{name}, zero, sizeof(zero));
  return cudaMemcpyFromSymbol(out, g_sp_trace_{name}, sizeof(zero));
}}''', 1)
        (dst / fname).write_text(text)
    return labels


def phase_trace(model) -> None:
    tmp = Path(tempfile.mkdtemp())
    labels = instrumented_sources(tmp)
    build.CSRC_DIR = tmp
    lib = build.load_library()
    B, S, L = SHAPES[0]
    args, dl, da = inputs(model, B, S, L)
    enc, comp = args[1], args[2]
    W = [w.detach() for w in speller_weights(model)]
    gmodel, glm = greedy_models()
    gB = 16
    mem = greedy_inputs(gmodel, gB)
    buf = (ctypes.c_longlong * 128)()
    with torch.no_grad():
        out = ks.spell_fwd(*args, with_gates=True)
        # (what, traced loop, call, steps a call)
        calls = [(f"spell_fwd B={B} S={S} L={L}", "fwd",
                  lambda: ks.spell_fwd(*args, with_gates=True), L),
                 (f"spell_bwd B={B} S={S} L={L}", "bwd",
                  lambda: ks.spell_bwd(enc, comp, dl, da, out[1:7], W, out[7:]), L)]
        calls += [(f"greedy_decode{'_lm' if lm_ is not None else ''} B={gB} S={GREEDY_S}",
                   "greedy", lambda lm_=lm_: kd.greedy_decode(gmodel, *mem, GREEDY_STEPS, lm_, 0.5),
                   GREEDY_STEPS) for lm_ in (None, glm)]
        for what, name, fn, L_ in calls:
            trace = getattr(lib, f"ss_sp_trace_{name}")
            trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
            fn()
            torch.cuda.synchronize()
            trace(None, 1)
            for _ in range(TRACE_REPS):
                fn()
            torch.cuda.synchronize()
            trace(ctypes.cast(buf, ctypes.c_void_p), 0)
            steps = TRACE_REPS * L_
            print(f"{what}: {sum(buf[1:]) / steps:.0f} cycles a step (CTA 0 of tile 0)",
                  flush=True)
            for (kernel, i), label in sorted(labels.items(), key=lambda kv: kv[0][1]):
                if kernel == name:
                    print(f"  {buf[i] / steps:8.0f}  up to line {label}")
    shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", action="store_true", help="cycles a step by phase instead")
    ap.add_argument("--greedy", action="store_true", help="K6 / K7's route table instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spell_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.manual_seed(0)
    model = las.LAS(las.ASRConfig()).cuda().eval()
    if args.trace:
        phase_trace(model)
    elif args.greedy:
        build.load_library()
        greedy_table(*greedy_models())
    else:
        build.load_library()
        route_table(model)


if __name__ == "__main__":
    main()
