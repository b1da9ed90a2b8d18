#!/usr/bin/env python3
"""Drive the PyTorch port's greedy serving path once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases, in order; any failure exits non-zero:

1. Device: the card's name, and its name and power limit as nvidia-smi
   reports them.  No CUDA device: exit 1.
2. Build: compile ``ss_asr_tpu_torch/csrc/*.cu`` for sm_90a (timed).
3. Kernels against their plain PyTorch versions at the flagship width
   (conf/default.yaml asr.mdl: listener 4 x 256 per direction, speller
   2 x 256, attention 128, 40 mels, V = 50; char-LM 2 x 128), B = 16,
   seeded random weights:
   * lstm_fwd on the four listener layers' shapes (T = 512/256/128/64),
     both directions, ragged lengths including 0 and 1: y and cs within
     1e-4 of the plain loop;
   * greedy_decode and greedy_decode_lm on listener output: the tokens of
     the plain decode, except that a row may diverge at a step where the
     plain decode's top-2 score gap is below 1e-4 (the rest of that row is
     then not compared); at most 2 such rows of 16; and greedy_decode with
     a large EOS bias, so every row takes the early exit at step 0.
   Kernel and plain times are CUDA-event medians after a warm-up; the
   decode kernels are timed over all 200 steps (an EOS bias of -50 keeps
   every row decoding), which is the time the JSON line reports.
4. The main path: seeded flagship ASR and char-LM checkpoints are written,
   the port's HTTP server starts in-process in signal mode (sr 22050,
   max_batch 8, greedy), and concurrent POST /transcribe requests with
   seeded synthetic 1-5 s WAVs must all answer 200 with a text equal to a
   direct ``Transcriber.transcribe_signal_batch`` of the same signals; then
   again with the LM at lm_weight 0.5.  After one warm-up request, the
   kernels' launch counters are zeroed; they must be above 0 after the
   timed requests.
5. One JSON line of kernels, the nvidia-smi line, and last the contract
   line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
B = 16
LISTENER_T = (512, 256, 128, 64)  # frames into each listener layer at T = 512
LSTM_TOL = 1e-4
NEAR_TIE = 1e-4
MAX_NEAR_TIE_ROWS = 2
MAX_STEPS = 200
SR = 22050
N_REQUESTS = 8


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return proc.stdout.strip() if proc.returncode == 0 else f"nvidia-smi failed: {proc.stderr.strip()}"


def check_lstm(torch, rng, asr_tree):
    import numpy as np

    from ss_asr_tpu_torch.ops.kernels import lstm as klstm

    H = 256
    err_max, ms, plain_ms = 0.0, 0.0, 0.0
    for layer, T in zip(("pblstm1", "pblstm2", "pblstm3", "blstm4"), LISTENER_T):
        p = asr_tree["encoder"][layer]
        whh = torch.from_numpy(np.stack([p["fwd"]["w_hh"], p["bwd"]["w_hh"]])).cuda()
        gx = torch.from_numpy(rng.standard_normal((2, T, B, 4 * H)).astype("float32")).cuda()
        lens = rng.integers(2, T + 1, size=B)
        lens[:3] = (0, 1, T)
        lengths = torch.from_numpy(lens.astype("int32")).cuda()
        rev = (False, True)
        y, cs = klstm.lstm_fwd(gx, whh, lengths, rev)
        torch.cuda.synchronize()
        y_ref = torch.stack([klstm.lstm_seq_plain(gx[d], whh[d], lengths, rev[d])[0] for d in range(2)])
        cs_ref = torch.stack([klstm.lstm_seq_plain(gx[d], whh[d], lengths, rev[d])[1] for d in range(2)])
        err = float((y - y_ref).abs().max())
        err_cs = float((cs - cs_ref).abs().max())
        k_ms = cuda_ms(torch, lambda: klstm.lstm_fwd(gx, whh, lengths, rev))
        p_ms = cuda_ms(torch, lambda: [klstm.lstm_seq_plain(gx[d], whh[d], lengths, rev[d])
                                       for d in range(2)], reps=3)
        print(f"lstm_fwd {layer} T={T} B={B} H={H} 2 dirs: y max_abs_err {err:.3e} "
              f"cs max_abs_err {err_cs:.3e} kernel {k_ms:.3f} ms plain {p_ms:.3f} ms", flush=True)
        if not (err <= LSTM_TOL and err_cs <= LSTM_TOL):
            fail(f"lstm_fwd {layer}: y err {err}, cs err {err_cs} > {LSTM_TOL}")
        err_max = max(err_max, err)
        ms += k_ms
        plain_ms += p_ms
    return {"max_abs_err": err_max, "ms": ms, "plain_ms": plain_ms}


def plain_gaps(torch, model, enc_h, comp_h, enc_lens, toks, lm, lm_weight):
    """Top-2 score gap of the plain decode at each step, replaying its tokens."""
    from ss_asr_tpu_torch.models import charlm as charlm_mod
    from ss_asr_tpu_torch.models import las
    from ss_asr_tpu_torch.ops import rnn
    from ss_asr_tpu_torch.vocab import SOS_ID

    Bn, S, _ = enc_h.shape
    dev = enc_h.device
    valid = las.attention_mask(enc_lens, S)
    state = las.speller_init_state(Bn, model.cfg, dev)
    lm_state = charlm_mod.init_state(Bn, lm.cfg, dev) if lm is not None else None
    last = torch.full((Bn,), SOS_ID, dtype=torch.long, device=dev)
    gaps = []
    for t in range(toks.shape[1]):
        _, context = las.attention_step(model.attention, comp_h, enc_h, state[0][0], valid)
        state, dec_out = las.speller_step(
            model.decoder, torch.cat([rnn.embed(model.embed, last), context], -1), state)
        score = rnn.linear(model.char_trans, dec_out)
        if lm is not None:
            lm_logits, lm_state = charlm_mod.step(lm, last, lm_state)
            score = torch.log_softmax(score, -1) + lm_weight * torch.log_softmax(lm_logits, -1)
        top = torch.topk(score, 2, dim=-1).values
        gaps.append(top[:, 0] - top[:, 1])
        last = toks[:, t].long()
    return torch.stack(gaps, 1).cpu().numpy()


def compare_tokens(name, got, want, gaps):
    """Rows must agree up to a first divergence at a plain near-tie.
    Returns (near-tie rows, mask of the compared positions)."""
    import numpy as np

    near = 0
    compared = np.ones(want.shape, bool)
    for b in range(want.shape[0]):
        diff = (got[b] != want[b]).nonzero()[0]
        if diff.size == 0:
            continue
        d = int(diff[0])
        compared[b, d:] = False
        if gaps[b, d] >= NEAR_TIE:
            fail(f"{name}: row {b} diverges at step {d} (kernel {got[b, d]}, plain "
                 f"{want[b, d]}) where the plain top-2 gap is {gaps[b, d]:.3e}")
        near += 1
    print(f"{name}: tokens match the plain decode; near-tie rows {near} of {want.shape[0]}",
          flush=True)
    if near > MAX_NEAR_TIE_ROWS:
        fail(f"{name}: {near} near-tie rows > {MAX_NEAR_TIE_ROWS}")
    return near, compared


def check_decode(torch, rng, model, lm):
    from ss_asr_tpu_torch.models import las
    from ss_asr_tpu_torch.ops.kernels import decode as kdec
    from ss_asr_tpu_torch.vocab import EOS_ID

    x = torch.from_numpy(rng.standard_normal((B, 512, 40)).astype("float32")).cuda()
    lens = rng.integers(8, 513, size=B)
    lens[:2] = (3, 512)  # one row floors to zero listener steps
    x_lens = torch.from_numpy(lens.astype("int32")).cuda()
    with torch.inference_mode():
        enc_h, enc_lens = las.listener_apply(model.encoder, x, x_lens)
        comp_h = las.attention_precompute(model.attention, enc_h)
    out = {}
    for name, use_lm in (("greedy_decode", False), ("greedy_decode_lm", True)):
        lm_ = lm if use_lm else None
        with torch.inference_mode():
            got = kdec.greedy_decode(model, enc_h, comp_h, enc_lens, MAX_STEPS, lm_, 0.5)
            torch.cuda.synchronize()
            want = kdec.greedy_decode_plain(model, enc_h, comp_h, enc_lens, MAX_STEPS, lm_, 0.5)
            gaps = plain_gaps(torch, model, enc_h, comp_h, enc_lens, want, lm_, 0.5)
            got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
            near, compared = compare_tokens(name, got_np, want_np, gaps)
            k_ms = cuda_ms(torch, lambda: kdec.greedy_decode(
                model, enc_h, comp_h, enc_lens, MAX_STEPS, lm_, 0.5))
            p_ms = cuda_ms(torch, lambda: kdec.greedy_decode_plain(
                model, enc_h, comp_h, enc_lens, MAX_STEPS, lm_, 0.5), reps=3)
        ends = [(r == EOS_ID).nonzero()[0] for r in got_np]
        steps = max(int(e[0]) + 1 if e.size else MAX_STEPS for e in ends)
        # token ids, over the compared positions: 0 when they all agree
        err = int(abs(got_np.astype("int64") - want_np.astype("int64"))[compared].max())
        print(f"{name} B={B} S={enc_h.shape[1]} max_steps={MAX_STEPS}, seeded weights "
              f"({steps} steps): kernel {k_ms:.3f} ms plain {p_ms:.3f} ms", flush=True)
        out[name] = {"max_abs_err": err, "ms": k_ms,
                     "plain_ms": p_ms, "near_tie_rows": near}

    biased = {}
    for bias in (50.0, -50.0):
        biased[bias] = copy.deepcopy(model)
        with torch.no_grad():
            biased[bias].char_trans.bias[EOS_ID] = bias
    with torch.inference_mode():
        got = kdec.greedy_decode(biased[50.0], enc_h, comp_h, enc_lens, MAX_STEPS).cpu().numpy()
        want = kdec.greedy_decode_plain(biased[50.0], enc_h, comp_h, enc_lens,
                                        MAX_STEPS).cpu().numpy()
    if not ((got == want).all() and (got[:, 0] == EOS_ID).all() and (got[:, 1:] == 0).all()):
        fail("greedy_decode early exit: tokens differ from the plain decode")
    print("greedy_decode early exit (EOS bias 50): every row EOS at step 0, then SOS; "
          "equal to the plain decode", flush=True)

    # per-step cost: an EOS bias of -50 keeps every row decoding all MAX_STEPS
    for name, use_lm in (("greedy_decode", False), ("greedy_decode_lm", True)):
        m, lm_ = biased[-50.0], (lm if use_lm else None)
        with torch.inference_mode():
            k_ms = cuda_ms(torch, lambda: kdec.greedy_decode(
                m, enc_h, comp_h, enc_lens, MAX_STEPS, lm_, 0.5))
            p_ms = cuda_ms(torch, lambda: kdec.greedy_decode_plain(
                m, enc_h, comp_h, enc_lens, MAX_STEPS, lm_, 0.5), reps=3)
            toks = kdec.greedy_decode(m, enc_h, comp_h, enc_lens, MAX_STEPS, lm_, 0.5)
        if bool((toks == EOS_ID).any()):
            fail(f"{name}: an EOS bias of -50 still emitted EOS")
        print(f"{name} full {MAX_STEPS} steps B={B} S={enc_h.shape[1]}: kernel {k_ms:.3f} ms "
              f"({1e3 * k_ms / MAX_STEPS:.1f} us/step), plain {p_ms:.3f} ms "
              f"({1e3 * p_ms / MAX_STEPS:.1f} us/step)", flush=True)
        out[name].update(ms=k_ms, plain_ms=p_ms)
    return out


def wav_bytes(y, sr) -> bytes:
    import numpy as np

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(y, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def synthetic_signals(rng):
    """Seeded 1-5 s waveforms: a few harmonic tones with noise."""
    import numpy as np

    sigs = []
    for _ in range(N_REQUESTS):
        n = int(rng.uniform(1.0, 5.0) * SR)
        t = np.arange(n) / SR
        y = sum(0.2 * np.sin(2 * np.pi * f * t) for f in rng.uniform(100, 3000, size=3))
        y = y + 0.05 * rng.standard_normal(n)
        sigs.append(y.astype(np.float32))
    return sigs


def serve_phase(torch, asr_path, lm_path, sigs):
    from ss_asr_tpu_torch.api import Transcriber
    from ss_asr_tpu_torch.data.audio import read_wav
    from ss_asr_tpu_torch.ops.kernels import decode as kdec
    from ss_asr_tpu_torch.ops.kernels import lstm as klstm
    from ss_asr_tpu_torch.serve import BatchingTranscriber, serve_http

    kw = {"lm_weight": 0.5} if lm_path else {}
    t = Transcriber.from_checkpoint(asr_path, config={}, lm_path=lm_path, device="cuda",
                                    beam_size=1, max_steps=MAX_STEPS, sr=SR, **kw)
    bodies = [wav_bytes(s, SR) for s in sigs]
    # the server's signals are the WAVs' int16 samples read back
    direct = t.transcribe_signal_batch([read_wav(io.BytesIO(b))[1] for b in bodies], sr=SR)
    ready = threading.Event()
    counters = (klstm.LAUNCHES, kdec.LAUNCHES)
    with BatchingTranscriber(t, max_batch=8, max_wait_ms=1000, mode="signal", sr=SR) as bt:
        server = serve_http(bt, host="127.0.0.1", port=0, ready_event=ready)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}/transcribe"
            # the server is local: never route its requests through an environment proxy
            opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

            def post(body):
                with opener.open(urllib.request.Request(url, data=body), timeout=300) as r:
                    return r.status, json.load(r)

            post(bodies[0])  # warm-up: lazy CUDA/cuBLAS set-up, not steady state
            for c in counters:
                for k in c:
                    c[k] = 0
            t0 = time.perf_counter()
            with ThreadPoolExecutor(N_REQUESTS) as ex:
                replies = list(ex.map(post, bodies))
            secs = time.perf_counter() - t0
            launches = {k: v for c in counters for k, v in c.items()}
        finally:
            server.shutdown()
            server.server_close()
            th.join(timeout=30)
    tag = "serve+lm" if lm_path else "serve"
    for i, (status, obj) in enumerate(replies):
        if status != 200 or "text" not in obj:
            fail(f"{tag}: request {i} answered {status} {obj}")
        if obj["text"] != direct[i]:
            fail(f"{tag}: request {i} text {obj['text']!r} != direct {direct[i]!r}")
    print(f"{tag}: {len(replies)} requests, all 200, texts equal the direct batch; "
          f"{secs:.3f} s, {len(replies) / secs:.3f} utt/s; launches {launches}", flush=True)
    return launches, secs


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "ss_asr_tpu_torch")):
        fail(f"ss_asr_tpu_torch not found beside {os.path.basename(__file__)}: run from a checkout")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)

    # phase 2: build
    from ss_asr_tpu_torch import convert
    from ss_asr_tpu_torch.models import charlm, las
    from ss_asr_tpu_torch.ops.kernels import build
    from ss_asr_tpu_torch.utils.checkpoint import save_pytree

    t0 = time.perf_counter()
    lib_path = build.build_library()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(lib_path, HERE)}", flush=True)

    # phase 3: kernels against their plain versions
    cfg = las.ASRConfig()
    lm_cfg = charlm.CharLMConfig()
    asr_tree = convert.init_asr_numpy(SEED, cfg)
    lm_tree = convert.init_charlm_numpy(SEED + 1, lm_cfg)
    model = las.LAS(cfg)
    model.load_state_dict(convert.asr_state_from_params(asr_tree))
    model = model.cuda().eval()
    lm = charlm.CharLM(lm_cfg)
    lm.load_state_dict(convert.charlm_state_from_params(lm_tree))
    lm = lm.cuda().eval()
    rng = np.random.default_rng(SEED)
    results = {"lstm_fwd": check_lstm(torch, rng, asr_tree)}
    results.update(check_decode(torch, rng, model, lm))

    # phase 4: the main path through the HTTP server
    sigs = synthetic_signals(rng)
    with tempfile.TemporaryDirectory() as tmp:
        asr_path = os.path.join(tmp, "asr.npz")
        lm_path = os.path.join(tmp, "char_lm.npz")
        save_pytree(asr_path, asr_tree)
        save_pytree(lm_path, lm_tree)
        launches, _ = serve_phase(torch, asr_path, None, sigs)
        launches_lm, _ = serve_phase(torch, asr_path, lm_path, sigs)
    for name in ("lstm_fwd", "greedy_decode"):
        if launches[name] < 1:
            fail(f"the server phase launched {name} {launches[name]} times")
    if launches_lm["greedy_decode_lm"] < 1 or launches_lm["lstm_fwd"] < 1:
        fail(f"the LM server phase launched {launches_lm}")
    counts = {"lstm_fwd": launches["lstm_fwd"] + launches_lm["lstm_fwd"],
              "greedy_decode": launches["greedy_decode"],
              "greedy_decode_lm": launches_lm["greedy_decode_lm"]}

    replaces = {"lstm_fwd": ("lstm_fwd.cu", "ss_asr_tpu/ops/pallas/lstm.py:149"),
                "greedy_decode": ("greedy_decode.cu", "ss_asr_tpu/ops/pallas/decode.py:33"),
                "greedy_decode_lm": ("greedy_decode.cu", "ss_asr_tpu/ops/pallas/decode.py:281")}
    kernels = [{"name": name, "route": "cuda", "source": f"ss_asr_tpu_torch/csrc/{src}",
                "replaces": rep, "launches": counts[name],
                "max_abs_err": results[name]["max_abs_err"], "ms": results[name]["ms"],
                "plain_ms": results[name]["plain_ms"]}
               for name, (src, rep) in replaces.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
