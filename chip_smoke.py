#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, data-preparation and test paths
once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases, in order; any failure exits non-zero:

1. Device: the card's name, and its name and power limit as nvidia-smi
   reports them.  No CUDA device: exit 1.
2. Build: compile ``ss_asr_tpu_torch/csrc/*.cu`` for sm_90a (timed).
3. Kernels against their plain PyTorch versions at the flagship width
   (conf/default.yaml asr.mdl: listener 4 x 256 per direction, speller
   2 x 256, attention 128, 40 mels, V = 50; char-LM 2 x 128), seeded random
   weights:
   * lstm_fwd on the four listener layers' shapes (B = 16, T = 512/256/
     128/64), both directions, ragged lengths including 0 and 1: y and cs
     within 1e-4 of the plain loop;
   * greedy_decode and greedy_decode_lm on listener output (B = 16, S =
     64), each launch on the cluster route (its own launch counter): the
     tokens of the plain decode, except that a row may diverge at a step
     where the plain decode's top-2 score gap is below 1e-4 (the rest of
     that row is then not compared); at most 2 such rows of 16; both with a
     large EOS bias, so every row takes the early exit at step 0; and the
     cluster route by shape timed against the one-row kernel at B = 16 and
     the server's B = 8;
   * beam_decode and beam_decode_lm (K = 3, 8 and 16, B = 16, S = 64)
     against beam_scan_plain, each on the cluster route by shape (its
     counter); at K = 3 and 8 tokens and parents by the same near-tie rule (the
     gap is the smallest between neighbours among the K + 1 best
     candidates, replayed along the plain path).  A divergent row whose two
     candidates a float64 replay of the plain path puts within 4 float32
     ulps and within 1e-4 of each other is a float32 tie: at most 4 such
     rows of 16, and at most 2 other near-tie rows, beyond those that the
     plain version run on the host splits from the card's plain version by
     the same rule on the same inputs (two float32 summation orders: on
     random weights over 200 steps at K = 8 any change of rounding splits
     5-7 rows at float32 ties).  Final scores within 1e-3, done flags and
     lengths equal on the rows that never diverged.  At K = 16, where
     float32 ties come every few steps and nearly every row parts from the
     plain version somewhere in 200 steps, whatever the float32 order, each
     row that parts must do so at a plain gap below 1e-4, the rows that part
     other than at a float32 tie (the float64 witness above) number at most
     2 more than the one-block kernel's (another float32 order) on the same
     inputs, and the final scores, done flags and lengths are compared on
     the rows that never part.  At
     every width, on every row, the kernel's own path, replayed through the
     plain step, has each pick within 1e-3 of the step's K best and ends at
     the kernel's scores (within 1e-3), done flags and lengths.  With an EOS
     bias of +50 every beam ends within two steps, equal to the plain
     frontier; K8's routes are timed at K = 3 and 8 (B = 16 and 8) and K =
     16 (B = 16, 8 and 1), the one-block kernel beside each, with the bound;
   * spell_fwd (K9) at the ASR step's shape (B = 32, L = 48, S = 64), the
     TAE step's (B = 64, S = 48) and the alignment shape (B * n = 16, L =
     16), teacher-forced (tf 1.0), scheduled sampling (tf 0.9, draws from a
     seeded torch.Generator) and greedy feedback, on the route by shape
     (which must be the cluster route): all seven streams and the two gate
     streams within 1e-4 of the plain loop; at tf 0.9 also the one-row
     kernel's seven streams, and every route timed (each tile height, the
     one-row kernel).
   * lstm_bwd (K3) on the listener layers' shapes at the training batch
     (B = 32, T = 512/256/128/64, both directions, ragged lengths with 0
     and 1) and spell_bwd (K10) at B = 32, L = 48, S = 64, tf 0.9 and 1.0
     (with a cotangent on the attention maps) and at the TAE step's B = 64,
     S = 48, on the cluster route (from K9's gates) and the one-row kernel,
     every route timed: K3's dgx and dW_hh, K10's
     five streams, each held by a float64 anchor: its relative L2 error
     against a float64 run of the plain version at most 4x the plain
     float32 version's own error against that run, and at most 1e-4.  The
     flagship shapes must take K3's cluster route (its own launch counter);
     K3 is also held at a small cluster (H = 128) and at a shape that takes
     the streaming route (H = 384), and its first layer is timed at every
     tile height and on the streaming route.
   * fbank (K11, the fused log-mel frontend) on reflect-padded signals at
     its callers' shapes: the training batch (B = 32, 512 frames, sr 22050,
     ragged), a preprocess batch (B = 64, sr 16000, rows of one sample), the
     server batch (B = 8) and one streaming block.  The log magnifies
     summation-order differences without limit on silent frames, so: within
     1e-4 of fbank_plain in the log domain for every energy within 60 dB of
     its frame's peak, and every energy within 1e-5 of the row's largest in
     the linear domain.
   Beside each kernel's time stand its bound (the larger of its float32
   operations over 67 TFLOP/s and its bytes, inputs once and outputs once,
   over 3.35 TB/s; K11's DFT product, which runs on the tensor cores, at
   the TF32 rate of 495 TFLOP/s, with the float32 figure beside it as
   ``bound_f32_ms``) and, where one PyTorch call computes the same function,
   that call's time: a cuDNN ``nn.LSTM`` layer for K2 (forward) and K3
   (forward + backward), the two-matmul pipeline for K11.
   Kernel and plain times are CUDA-event medians after a warm-up; the
   decode kernels are timed over all 200 steps (an EOS bias of -50 keeps
   every row decoding), which is the time the JSON line reports.
4. Data preparation: ``cli.mkdata`` and ``cli.preprocess generic`` as
   subprocesses on 160 tone utterances at 16 kHz (K11 must launch there;
   ``index.tsv`` lists the corpus; every fbank equals the plain frontend by
   K11's rule).
5. The char-LM at the full width of conf/default.yaml (2 GRU x 128, chunks
   of 200 characters, B = 128, Adam 1e-4, tf 0.9) on a text corpus of the
   tone corpus's normalised texts (SOS and EOS included) and seeded
   sentences of its words (four batches an epoch): one step (the unroll of 200 steps with scheduled
   sampling, draws from one seeded generator) on the card and on the CPU
   against a float64 run by the anchored rule of phase 8; 5 timed steps
   with a profile; ``python -m ss_asr_tpu_torch.cli.train CHARLMTrainer``
   for 20 epochs, whose last epoch's mean loss per character must be below
   its first's; ``cli.generate`` and ``cli.lm_predict`` on the trained
   ``char_lm.npz``.  That LM is the one every later LM Transcriber loads;
   the seeded random LM serves only the kernel checks of phase 3.
6. Greedy serving: a seeded flagship ASR checkpoint is written, the port's
   HTTP server starts in-process in signal mode (sr 22050, max_batch 8,
   greedy), and concurrent POST /transcribe requests with seeded synthetic
   1-5 s WAVs must all answer 200 with a text equal to a direct
   ``Transcriber.transcribe_signal_batch`` of the same signals; then again
   with the trained LM at lm_weight 0.5.  Every greedy launch there takes
   the cluster route.
7. Serving under conf/default.yaml's decode settings (beam 3; with the LM,
   weight 0.5): the same concurrent requests without and with the LM, then
   with the LM ``?detail=1&nbest=3``, ``?long=1`` on a seeded 45 s signal,
   one ``/stream`` session and one ``/reload`` of a new checkpoint; every
   reply 200 and equal to the direct ``Transcriber`` call, which is made
   before the server starts.
   Each serving path (each phase's batch, each route) zeroes the kernels'
   launch counters just before its requests (after one warm-up request)
   and reads them just after its last reply; every kernel the path runs
   must have launched (K11 on every one of them: the server is in signal
   mode), and the JSON line's launches sum these counts.  After each
   phase's server has stopped, a torch.profiler split of three direct
   batches says where a steady batch's time goes.
8. The train step at the flagship (B = 32, T = 512 frames from seeded
   waveforms, L = 48, conf/default.yaml's Adadelta): an ``ASRTrainer`` on
   the card and one on the CPU (plain versions) take one step on the same
   batch with the same draws, held to a float64 run of the plain versions
   on the CPU: the card's relative L2 error of the loss and of every
   gradient tensor at most 4x the CPU float32 run's own, or below 1e-5;
   every trained parameter, the listener's included, with a gradient.
   Then 12 steps (frontend from the waveform + forward + backward + clip +
   Adadelta) timed with CUDA events, the launch counters zeroed just
   before and read just after (K2, K3, K9 and K10 must launch, every K2,
   K3, K9 and K10 launch on the cluster route), and a torch.profiler split
   of 3 steps.  Then ``python -m ss_asr_tpu_torch.cli.train ASRTrainer``
   as a subprocess on a seeded corpus of 40 utterances (40 mels, 300-512
   frames, texts up to 48 ids), split by ``data.index.make_split`` (90 /
   10, seeded) into a train index of one batch and a held-out validation
   index: 30 steps of the one batch, whose loss must fall, writing
   ``asr.npz``, ``asr_opt.npz`` and ``tracker.json``; a second invocation
   resumes at step 30.
9. The semi-supervised trainers at the full width of conf/default.yaml:
   one TAE step (B = 64), one SAE step (B = 32, T = 512) and one ADV
   D-step and G-step (B = 32): each loss and every gradient on the card
   against the CPU's plain versions by the float64-anchored rule of phase
   8; then timed updates with the launch counters zeroed before and read
   after (K2 / K3, and K9 / K10 for the TAE, must launch, each on its
   cluster route), every parameter outside the optimizer's mask
   bit-unchanged and every one inside moved.  Then ``cli.train Seed`` as a
   subprocess on the train side of a seeded held-out split of the
   preprocessed corpus, validating on the other (TAE -> ADV -> SAE, the
   three ASR relays written) and ``cli.train ASRTrainer`` from the last
   relay, whose loss must fall.
10. The tester and the tools: ``cli.train ASRTester`` (in this process, so
   that the launch counters see it; batches of 8) on the held-out side of
   that split with the relay ASRTrainer left and the trained LM, greedy
   without the LM and under conf/default.yaml's decode settings (beam 3 +
   LM 0.5, step cap 0.25 of the frames): each run's launches counted (K2
   and K6, or K2 and K8 with the LM, every one on the cluster route), its
   transcripts equal to direct ``greedy_decode_early_exit`` / ``beam_decode``
   calls on the same batches, its utt/s, WER and CER printed.  Then a
   bounded ``cli.train ASRTrainer`` run (200 epochs of the 4 train batches,
   ``keep_snapshots: 2``) and both tests again: the greedy CER must fall.
   Then ``cli.pseudolabel`` (beam 3 + LM 0.5, K11, K2, K8 and K9 counted)
   on 8 held-out wavs, whose kept rows must load through ``ASRDataset``,
   and ``cli.avg_ckpt`` of the two snapshots, every leaf within half a
   float32 ulp of the float64 mean.
11. The trainers' options and ``import_ckpt``, on a random stream of their
   own: (a) SpecAugment at B = 32, T = 512, F = 40, the default masks and
   the adaptive ones, from the same draws on the card and the CPU: the
   masks equal, the masked values within 1e-6 relative, the card's ms;
   (b) the flagship update as ``accum_steps: 2`` over two micro-batches of
   16 (teacher-forced, so that they and the whole batch see the same
   feedback) on the card, the CPU and in float64: every update and
   Adadelta slot by the anchored rule of phase 8, and the same update as
   one batch of 32 on the card against that float64 run; then the
   accumulated update as a user runs it (frontend + SpecAugment + forward
   + backward per micro-batch at tf 0.9, clip + Adadelta once) timed beside
   the one-batch step, launches counted (K11, K2, K3, K9, K10, each on its
   cluster route) and both profiled; (c) ``warmup_steps: 3, decay_steps:
   5, end_scale: 0.1`` for 10 SGD updates on the card, each rate within
   1e-6 of the float64 formula; (d) ``cli.train ASRTrainer`` as a
   subprocess with accumulation, the schedule and SpecAugment, stopped
   after 3 micro-steps: ``asr_opt.npz`` holds ``mini_step`` 1 and a
   non-zero running mean, a trainer built on it reads every leaf back, and
   a second invocation resumes to step 7; (e) one accumulated update of
   each of the TAE, SAE, ADV (D and G) and char-LM trainers on the card,
   the CPU and in float64: each micro-batch's loss and gradients by the
   anchored rule (with its max-pool and ReLU witnesses), then every update
   and slot; (f) ``cli.import_ckpt --export`` of phase 10's trained ASR
   and LM and the import back, every array bit-equal, and the imported
   pair behind the server under the default decode: its transcripts equal
   the original pair's.
12. Data parallelism and mesh serving, on a random stream of their own:
   (a) the flagship ASR step (global batch 32 = 2 x 16, T = 512, L = 48, tf
   0.9, the frontend from the waveforms) over two ranks in processes of
   their own (``spawn``) sharing the card under gloo, 3 steps: the ranks'
   parameters bit-equal after every step, each rank's launches counted
   (K11, K2, K3, K9, K10 on their cluster routes), the losses and updates
   held against one process on the joined batch by the anchored rule of
   phase 8 (a float64 run of the plain versions; the ranks' error at most
   4x the CPU float32 run's, or below 1e-5), and the step's wall (CUDA
   events) beside that process's; (b) ``cli.train ASRTrainer`` through
   ``python -m torch.distributed.run --nproc-per-node 2`` with ``parallel:
   {distributed: true, n_data: auto}`` on 31 tone utterances (the step cap
   trims one rank), one ckpdir saved to every step by rank 0: both ranks
   log the same losses at the same steps, and a second invocation resumes
   on both at the saved step; (c) ``Transcriber(mesh=make_mesh(devices=
   [card, card]))`` on the phase-6 signals, greedy, greedy + LM and the
   default decode: each shard's kernels counted, the transcripts equal the
   single device's (or, where they differ, divergent only at a near tie of
   the single device's path, at most 2 rows), a batch's wall on each side
   (median of 5), then the HTTP server over the mesh Transcriber (default
   decode) with ``?detail=1&nbest=3`` and one ``/reload``.  A failed
   collective or a rank still running after 180 s fails the phase.
13. Tensor parallelism (``parallel: {n_data: D, n_model: M}``): (a) the
   flagship ASR step on phase 12's batch (B = 32, tf 0.9) at (data, model)
   = (1, 2), two ranks sharing the card under gloo, each running the whole
   batch on the weights gathered from the two ranks' shards, 3 steps: the
   ranks' gathered parameters bit-equal after every step, each rank
   launching exactly K11 1, K2 4, K3 4, K9 1, K10 1 a step on the cluster
   routes, the losses and updates held against phase 12's one process on
   the same batch by the anchored rule, the step's wall beside that
   process's and the bytes each rank gathered and reduced a step beside
   what column-parallel input projections would move; (b) ``cli.train
   ASRTrainer`` through ``torchrun --nproc-per-node 4`` at (2, 2) on 31
   tone utterances: every rank logs the same losses, rank 0 alone writes
   (saved every step), every rank resumes at the saved step, the
   checkpoint's parameter and optimizer leaves full width and within 1e-5
   relative of phase 12 (b)'s (its data axis reads the same rows and
   draws), and the checkpoint decodes in a greedy ``Transcriber`` (its
   launches counted).
14. The smoke's wall time, one JSON line of kernels (launches on the paths
   above, error, kernel / plain / library times, bound), the nvidia-smi
   line, and last the contract line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
B = 16
FRAMES = 512  # fbank frames into the listener: S = 64 encoder steps
DEVICE = "cuda"
LSTM_TOL = 1e-4
NEAR_TIE = 1e-4
MAX_NEAR_TIE_ROWS = 2
MAX_F32_TIE_ROWS = 4
F32_TIE_ULPS = 4
MAX_STEPS = 200
SR = 22050
N_REQUESTS = 8
BEAM_WIDTHS = (3, 8, 16)
SCORE_TOL = 1e-3
SPELL_TOL = 1e-4
# (B, L, S): the ASR step, the TAE step (its text memory is at most 48 long), the alignment pass
SPELL_SHAPES = ((32, 48, 64), (64, 48, 48), (16, 16, 64))
LONG_SECONDS = 45.0
TRAIN_B = 32  # the training flagship: B = 32, T = 512 frames, L = 48 decode steps
TRAIN_L = 48
TRAIN_MIN_FRAMES = 300  # utterances of 300-512 frames
TRAIN_STEPS = 12  # timed train steps (the median is reported)
CLI_STEPS = 30  # steps of cli.train on one repeated batch
CLI_UTTS = 40  # its corpus: a seeded 90 / 10 split leaves one batch of TRAIN_B to train on
ANCHOR_RATIO = 4.0  # a backward kernel's error vs float64: at most 4x the plain float32's
ANCHOR_MAX = 1e-4  # ... and at most this relative L2
STEP_FLOOR = 1e-5  # the train step: card error vs float64 within 4x the CPU's, or below this
PRE_UTTS = 160  # utterances of the preprocess phase's corpus (two full groups of 64 and a part)
PRE_SR = 16000  # its sample rate (the tone corpus is resampled from 8 kHz)
AUX_STEPS = 5  # timed updates of each auxiliary trainer (the median is reported)
# seeded draws of the ADV D-step's batch, each compared with float64 (relu_flip_sweep)
ADV_SEEDS = tuple(range(SEED + 100, SEED + 108))
SEED_EPOCHS = {"tae": 6, "adv": 2, "sae": 2, "asr": 3}  # epochs per stage of the Seed run
LM_BATCHES = 4  # the char-LM corpus: this many batches (of 128 chunks of 200 characters) an epoch
LM_EPOCHS = 20  # epochs of cli.train CHARLMTrainer
TEST_B = 8  # the tester's batch (the server's)
EXTRA_EPOCHS = 200  # the bounded ASRTrainer run before the second test: 4 steps an epoch
PSEUDO_UTTS = 8  # held-out wavs that cli.pseudolabel labels
PSEUDO_FLOOR = -2.0  # its --min-avg-logprob (the fused score a character: LM 0.5 included)


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
    """K2 against lstm_seq_plain on the four listener layers' shapes (B = 16,
    both directions, ragged lengths including 0 and 1), on the cluster route
    (its launch counter must say so), two runs bit-equal; the first layer
    timed at every tile height and on the streaming route, and the TAE's
    text-encoder shape (B = 64, T = 48: 16 clusters where the card holds 15)
    on both routes."""
    import numpy as np

    from ss_asr_tpu_torch.ops.kernels import lstm as klstm

    H = asr_tree["encoder"]["blstm4"]["fwd"]["w_hh"].shape[0]
    err_max, ms, plain_ms, lib_ms, ops, moved = 0.0, 0.0, 0.0, 0.0, 0.0, 0
    rev = (False, True)
    route = klstm.lstm_fwd_route(H, B, 2)
    if route[0] == 0:
        fail(f"lstm_fwd: H={H} B={B} takes the streaming route, not a cluster")
    held = klstm.resident_clusters(H, route[0], route[1], DEVICE, forward=True)
    print(f"lstm_fwd H={H} B={B}: clusters of {route[0]} CTAs, tiles of {route[1]} rows: "
          f"{-(-B // route[1]) * 2} clusters, of which the card holds {held} at once "
          f"(the route's table says {klstm.CARD_CLUSTERS[route[0]]})", flush=True)

    def operands(T, Bn, gen=rng):
        gx = torch.from_numpy(gen.standard_normal((2, T, Bn, 4 * H)).astype("float32")).to(DEVICE)
        lens = gen.integers(2, T + 1, size=Bn)
        lens[:3] = (0, 1, T)
        return gx, torch.from_numpy(lens.astype("int32")).to(DEVICE)

    # the shapes timed beside the flagship's draw from their own stream, so that the
    # phases after this one see the inputs they always saw
    extra = np.random.default_rng(SEED + 11)

    # frames into each listener layer: the pyramid halves time three times
    for layer, T in zip(("pblstm1", "pblstm2", "pblstm3", "blstm4"),
                        (FRAMES, FRAMES // 2, FRAMES // 4, FRAMES // 8)):
        p = asr_tree["encoder"][layer]
        whh = torch.from_numpy(np.stack([p["fwd"]["w_hh"], p["bwd"]["w_hh"]])).to(DEVICE)
        gx, lengths = operands(T, B)
        before = klstm.LAUNCHES["lstm_fwd_cluster"]
        y, cs = klstm.lstm_fwd(gx, whh, lengths, rev)
        torch.cuda.synchronize()
        if klstm.LAUNCHES["lstm_fwd_cluster"] != before + 1:
            fail(f"lstm_fwd {layer}: the flagship shape did not take the cluster route")
        again = klstm.lstm_fwd(gx, whh, lengths, rev)
        if not (torch.equal(again[0], y) and torch.equal(again[1], cs)):
            fail(f"lstm_fwd {layer}: two runs differ")
        y_ref = torch.stack([klstm.lstm_seq_plain(gx[d], whh[d], lengths, rev[d])[0] for d in range(2)])
        cs_ref = torch.stack([klstm.lstm_seq_plain(gx[d], whh[d], lengths, rev[d])[1] for d in range(2)])
        err = float((y - y_ref).abs().max())
        err_cs = float((cs - cs_ref).abs().max())
        k_ms = cuda_ms(torch, lambda: klstm.lstm_fwd(gx, whh, lengths, rev))
        p_ms = cuda_ms(torch, lambda: [klstm.lstm_seq_plain(gx[d], whh[d], lengths, rev[d])
                                       for d in range(2)], reps=3)
        l_ms = cudnn_lstm_ms(torch, p["fwd"]["w_ih"].shape[0], H, T, B, backward=False)
        print(f"lstm_fwd {layer} T={T} B={B} H={H} 2 dirs (cluster of {route[0]}, tiles of "
              f"{route[1]} rows): y max_abs_err {err:.3e} cs max_abs_err {err_cs:.3e}, two runs "
              f"bit-equal; kernel {k_ms:.3f} ms ({k_ms / T * 1e3:.2f} us per step) plain "
              f"{p_ms:.3f} ms cuDNN nn.LSTM forward {l_ms:.3f} ms", flush=True)
        if not (err <= LSTM_TOL and err_cs <= LSTM_TOL):
            fail(f"lstm_fwd {layer}: y err {err}, cs err {err_cs} > {LSTM_TOL}")
        if layer == "pblstm1":
            alt = {r: cuda_ms(torch, lambda: klstm.lstm_fwd(gx, whh, lengths, rev,
                                                             route=(route[0], r)))
                   for r in klstm.TILE_ROWS}
            old = cuda_ms(torch, lambda: klstm.lstm_fwd(gx, whh, lengths, rev, route=(0, 0)))
            print(f"lstm_fwd {layer} B={B}: tiles of "
                  + ", ".join(f"{r} rows {ms_r:.3f} ms" for r, ms_r in alt.items())
                  + f"; the streaming route {old:.3f} ms", flush=True)
            # the training batch: every tile height that keeps the clusters in one wave or two
            gx32, len32 = operands(T, TRAIN_B, extra)
            alt = {r: cuda_ms(torch, lambda: klstm.lstm_fwd(gx32, whh, len32, rev,
                                                             route=(route[0], r)))
                   for r in klstm.TILE_ROWS}
            old = cuda_ms(torch, lambda: klstm.lstm_fwd(gx32, whh, len32, rev, route=(0, 0)))
            print(f"lstm_fwd {layer} B={TRAIN_B}: route {klstm.lstm_fwd_route(H, TRAIN_B, 2)}; tiles of "
                  + ", ".join(f"{r} rows {ms_r:.3f} ms" for r, ms_r in alt.items())
                  + f"; the streaming route {old:.3f} ms", flush=True)
        err_max = max(err_max, err, err_cs)
        ms += k_ms
        plain_ms += p_ms
        lib_ms += l_ms
        ops += 2 * T * B * (8.0 * H * H + 24 * H)  # h @ W_hh, then the cell
        moved += nbytes(gx, whh, lengths, y, cs)
    # the TAE's text encoder: B = 64 rows of L = 48 characters
    p = asr_tree["encoder"]["blstm4"]
    whh = torch.from_numpy(np.stack([p["fwd"]["w_hh"], p["bwd"]["w_hh"]])).to(DEVICE)
    gx, lengths = operands(TRAIN_L, 64, extra)
    tae_route = klstm.lstm_fwd_route(H, 64, 2)
    y, cs = klstm.lstm_fwd(gx, whh, lengths, rev)
    y_ref, cs_ref = (torch.stack(v) for v in zip(*[klstm.lstm_seq_plain(gx[d], whh[d], lengths, rev[d])
                                                   for d in range(2)]))
    err = max(float((y - y_ref).abs().max()), float((cs - cs_ref).abs().max()))
    if not err <= LSTM_TOL:
        fail(f"lstm_fwd B=64 T={TRAIN_L}: err {err} > {LSTM_TOL}")
    by_route = cuda_ms(torch, lambda: klstm.lstm_fwd(gx, whh, lengths, rev))
    streamed = cuda_ms(torch, lambda: klstm.lstm_fwd(gx, whh, lengths, rev, route=(0, 0)))
    print(f"lstm_fwd B=64 T={TRAIN_L} (the TAE's text encoder): route {tae_route} "
          f"{-(-64 // tae_route[1]) * 2} clusters, max_abs_err {err:.3e}, {by_route:.3f} ms; the "
          f"streaming route {streamed:.3f} ms", flush=True)
    b_ms, b_by = bound(ops, moved)
    return {"max_abs_err": err_max, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by}


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


def compare_tokens(name, got, want, gaps, f32_tie=None):
    """Rows must agree up to a first divergence at a plain near-tie (gap
    below NEAR_TIE).  got / want [B, T, ...] (a step may hold several ids),
    gaps [B, T].  ``f32_tie(b, d)``, when given, is a second witness for row
    b's divergence at step d: (True, why) when float64 arithmetic puts the
    two candidates within float32 resolution (and NEAR_TIE) of each other,
    so that neither order is wrong.  Such rows count against MAX_F32_TIE_ROWS, the other
    divergent rows against MAX_NEAR_TIE_ROWS.  Returns (near-tie rows,
    float32-tie rows, mask [B, T] of the compared steps)."""
    import numpy as np

    near = ties = 0
    compared = np.ones(want.shape[:2], bool)
    neq = (got != want).reshape(want.shape[0], want.shape[1], -1).any(-1)
    for b in range(want.shape[0]):
        diff = neq[b].nonzero()[0]
        if diff.size == 0:
            continue
        d = int(diff[0])
        compared[b, d:] = False
        if gaps[b, d] >= NEAR_TIE:
            fail(f"{name}: row {b} diverges at step {d} (kernel {got[b, d].tolist()}, plain "
                 f"{want[b, d].tolist()}) where the plain gap is {gaps[b, d]:.3e}")
        tie, why = f32_tie(b, d) if f32_tie is not None else (False, "")
        ties += tie
        near += not tie
        print(f"{name}: row {b} diverges at step {d}, plain gap {gaps[b, d]:.3e}"
              f"{'; ' + why if why else ''}", flush=True)
    print(f"{name}: tokens match the plain version; near-tie rows {near} (at most "
          f"{MAX_NEAR_TIE_ROWS}), float32-tie rows {ties} (at most {MAX_F32_TIE_ROWS}) of "
          f"{want.shape[0]}", flush=True)
    if near > MAX_NEAR_TIE_ROWS or ties > MAX_F32_TIE_ROWS:
        fail(f"{name}: {near} near-tie rows (at most {MAX_NEAR_TIE_ROWS}), {ties} float32-tie "
             f"rows (at most {MAX_F32_TIE_ROWS})")
    return near, ties, compared


def replay_frontier(torch, model, lm, lm_weight, enc_h, comp_h, enc_lens, toks, parents):
    """Replay a beam frontier's choices through the plain step.

    toks / parents [T, B, K] are the choices of a frontier (the plain one's
    or a kernel's).  Each step's candidates are computed as beam_scan_plain
    computes them, in the dtype of ``model``, which enc_h and comp_h share,
    and the given choices are taken whatever their rank; like
    beam_scan_plain, the replay stops once every beam is done.  Returns
    (candidates [B, steps run, K * V], final scores [B, K] with the terminal
    EOS charge, done [B, K], hyp_len [B, K])."""
    from ss_asr_tpu_torch.models import charlm as charlm_mod
    from ss_asr_tpu_torch.models import las
    from ss_asr_tpu_torch.ops import rnn
    from ss_asr_tpu_torch.ops.kernels.beam import NEG_INF
    from ss_asr_tpu_torch.vocab import EOS_ID, SOS_ID

    T, Bn, K = toks.shape
    dev, dtype, S = enc_h.device, enc_h.dtype, enc_h.shape[1]
    V, H = model.cfg.vocab_size, model.cfg.decoder_state_size
    encK, compK = enc_h.repeat_interleave(K, 0), comp_h.repeat_interleave(K, 0)
    validK = las.attention_mask(enc_lens.to(dev), S).repeat_interleave(K, 0)

    def forward(state, lm_state, last):
        _, context = las.attention_step(model.attention, compK, encK, state[0][0], validK)
        state, dec_out = las.speller_step(
            model.decoder, torch.cat([rnn.embed(model.embed, last), context], -1), state)
        logp = torch.log_softmax(rnn.linear(model.char_trans, dec_out), -1)
        if lm is not None:
            lm_logits, lm_state = charlm_mod.step(lm, last, lm_state)
            logp = logp + lm_weight * torch.log_softmax(lm_logits, -1)
        return state, lm_state, logp.view(Bn, K, V)

    z = torch.zeros(Bn * K, H, dtype=dtype, device=dev)
    state, lm_state = ((z, z), (z, z)), None
    if lm is not None:
        zl = torch.zeros(Bn * K, lm.cfg.hidden_size, dtype=dtype, device=dev)
        lm_state = (zl, zl)
    last = torch.full((Bn * K,), SOS_ID, dtype=torch.long, device=dev)
    scores = torch.full((Bn, K), NEG_INF, dtype=dtype, device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros(Bn, K, dtype=torch.bool, device=dev)
    hyp_len = torch.zeros(Bn, K, dtype=torch.int32, device=dev)
    pad_row = torch.full((V,), NEG_INF, dtype=dtype, device=dev)
    pad_row[SOS_ID] = 0.0
    rows = torch.arange(Bn, device=dev)[:, None] * K
    cands = []
    for t in range(T):
        if bool(done.all()):
            break
        state, lm_state, logp = forward(state, lm_state, last)
        logp = torch.where(done[:, :, None], pad_row, logp)
        cand = (scores[:, :, None] + logp).reshape(Bn, K * V)
        cands.append(cand)
        parent, token = parents[t].long(), toks[t].long()
        flat = (rows + parent).reshape(-1)
        state = tuple(tuple(s[flat] for s in layer) for layer in state)
        if lm is not None:
            lm_state = tuple(s[flat] for s in lm_state)
        ended = torch.gather(done, 1, parent) | (token == EOS_ID)
        hyp_len = torch.gather(hyp_len, 1, parent) + (~ended).to(torch.int32)
        done = ended
        scores = torch.gather(cand, 1, parent * V + token)
        last = token.reshape(-1)
    _, _, logp = forward(state, lm_state, last)
    scores = torch.where(done, scores, scores + logp[:, :, EOS_ID])
    return torch.stack(cands, 1), scores, done, hyp_len


def frontier_gaps(torch, cands, K, T):
    """[B, T] numpy: the smallest gap between neighbours among each step's
    K + 1 best candidates, which says how close the step came to choosing or
    ordering its survivors otherwise (inf at the steps not run)."""
    import numpy as np

    top = torch.topk(cands, K + 1, dim=-1).values
    gaps = np.full((cands.shape[0], T), np.inf)
    gaps[:, : cands.shape[1]] = (top[..., :-1] - top[..., 1:]).min(-1).values.cpu().numpy()
    return gaps


def listener_memory(torch, rng, model, batch):
    """Listener output of seeded fbanks [batch, FRAMES, feat], ragged
    lengths (one row floors to zero listener steps)."""
    from ss_asr_tpu_torch.models import las

    feat = model.cfg.feature_dim
    x = torch.from_numpy(rng.standard_normal((batch, FRAMES, feat)).astype("float32")).to(DEVICE)
    lens = rng.integers(8, FRAMES + 1, size=batch)
    lens[:2] = (3, FRAMES)
    x_lens = torch.from_numpy(lens.astype("int32")).to(DEVICE)
    with torch.inference_mode():
        enc_h, enc_lens = las.listener_apply(model.encoder, x, x_lens)
        comp_h = las.attention_precompute(model.attention, enc_h)
    return enc_h, comp_h, enc_lens


def greedy_launch(torch, kdec, name, *args, route=None):
    """One ``kdec.greedy_decode(*args, route=route)`` with the launch
    counters zeroed just before and read just after: one launch, on the
    cluster route unless ``route`` is 0 (the one-row kernel); the route by
    shape (None) must take the cluster at every flagship greedy shape ->
    the raw tokens."""
    zero_launches()
    toks = kdec.greedy_decode(*args, route=route)
    torch.cuda.synchronize()
    took = read_launches()
    if took[name] != 1 or took[f"{name}_cluster"] != int(route != 0):
        fail(f"{name} route {route}: launches {took}, not one on the "
             f"{'one-row kernel' if route == 0 else 'cluster route'}")
    return toks


def check_greedy_routes(torch, kdec, name, m, mem, lm_, tag):
    """The tokens of the route by shape and of the one-row kernel against
    greedy_decode_plain on ``m, *mem`` over MAX_STEPS steps, by the
    near-tie rule -> (the tokens by shape, their near-tie rows, the largest
    token-id difference over the compared steps of either route)."""
    with torch.inference_mode():
        want = kdec.greedy_decode_plain(m, *mem, MAX_STEPS, lm_, 0.5)
        gaps = plain_gaps(torch, m, *mem, want, lm_, 0.5)
        got = {r: greedy_launch(torch, kdec, name, m, *mem, MAX_STEPS, lm_, 0.5, route=r)
               for r in (None, 0)}
    want_np, err, near = want.cpu().numpy(), 0, 0
    for r, toks in got.items():
        got_np = toks.cpu().numpy()
        n, _, compared = compare_tokens(
            f"{name} {tag} B={mem[0].shape[0]} {'by shape' if r is None else 'route 0'}",
            got_np, want_np, gaps)
        near = n if r is None else near
        # token ids, over the compared positions: 0 when they all agree
        err = max(err, int(abs(got_np.astype("int64") - want_np.astype("int64"))[compared].max()))
    return got[None].cpu().numpy(), near, err


def check_decode(torch, rng, model, lm):
    """K6 / K7 against greedy_decode_plain on the seeded listener memory,
    the route by shape (the cluster) and the one-row kernel alike; the early
    exit; and, with an EOS bias of -50 over all MAX_STEPS steps at B = 16
    and the server's B = 8, both routes checked again and timed."""
    from ss_asr_tpu_torch.ops.kernels import decode as kdec
    from ss_asr_tpu_torch.vocab import EOS_ID

    enc_h, comp_h, enc_lens = listener_memory(torch, rng, model, B)
    ws, lm_ws = kdec.speller_operands(model, enc_h.device), kdec.lm_operands(lm, enc_h.device)
    mem = (enc_h, comp_h, enc_lens)
    out = {}
    for name, use_lm in (("greedy_decode", False), ("greedy_decode_lm", True)):
        got_np, near, err = check_greedy_routes(torch, kdec, name, model, mem,
                                                lm if use_lm else None, "seeded")
        ends = [(r == EOS_ID).nonzero()[0] for r in got_np]
        steps = max(int(e[0]) + 1 if e.size else MAX_STEPS for e in ends)
        print(f"{name} B={B} S={enc_h.shape[1]} max_steps={MAX_STEPS}, seeded weights: "
              f"{steps} steps", flush=True)
        out[name] = {"max_abs_err": err, "near_tie_rows": near}

    biased = {bias: eos_biased(torch, model, bias) for bias in (50.0, -50.0)}
    for name, use_lm in (("greedy_decode", False), ("greedy_decode_lm", True)):
        lm_ = lm if use_lm else None
        with torch.inference_mode():
            got = greedy_launch(torch, kdec, name, biased[50.0], *mem, MAX_STEPS, lm_,
                                0.5).cpu().numpy()
            want = kdec.greedy_decode_plain(biased[50.0], *mem, MAX_STEPS, lm_, 0.5).cpu().numpy()
        if not ((got == want).all() and (got[:, 0] == EOS_ID).all() and (got[:, 1:] == 0).all()):
            fail(f"{name} early exit: tokens differ from the plain decode")
        print(f"{name} early exit (EOS bias 50), cluster route: every row EOS at step 0, then "
              "SOS; equal to the plain decode", flush=True)

    # per-step cost: an EOS bias of -50 keeps every row decoding all MAX_STEPS
    cfg = model.cfg
    for name, use_lm in (("greedy_decode", False), ("greedy_decode_lm", True)):
        m, lm_ = biased[-50.0], (lm if use_lm else None)
        for Bn in (B, N_REQUESTS):
            sub = tuple(t[:Bn].contiguous() for t in mem)
            by_shape = kdec.greedy_route(Bn, cfg.decoder_state_size, cfg.enc_out_dim,
                                         cfg.mlp_out_size, sub[0].shape[1], cfg.vocab_size,
                                         lm.cfg.hidden_size if use_lm else 0)
            toks, _, err = check_greedy_routes(torch, kdec, name, m, sub, lm_, "EOS bias -50")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            if bool((toks == EOS_ID).any()):
                fail(f"{name}: an EOS bias of -50 still emitted EOS")
            with torch.inference_mode():
                times = {r: cuda_ms(torch, lambda: kdec.greedy_decode(
                    m, *sub, MAX_STEPS, lm_, 0.5, route=r)) for r in (by_shape, 0)}
                if Bn == B:
                    p_ms = cuda_ms(torch, lambda: kdec.greedy_decode_plain(
                        m, *sub, MAX_STEPS, lm_, 0.5), reps=3)
            print(f"{name} full {MAX_STEPS} steps B={Bn} S={sub[0].shape[1]}: " + ", ".join(
                f"route {r}{' (by shape)' if r == by_shape else ' (one-row kernel)'} {ms:.3f} ms "
                f"({1e3 * ms / MAX_STEPS:.1f} us/step)" for r, ms in times.items())
                + (f", plain {p_ms:.3f} ms ({1e3 * p_ms / MAX_STEPS:.1f} us/step)"
                   if Bn == B else ""), flush=True)
            if Bn == B:
                k_ms = times[by_shape]
        # all MAX_STEPS steps ran: what this run's data needed
        b_ms, b_by = bound(
            B * MAX_STEPS * speller_row_ops(ws, enc_h.shape[1], lm_ws if use_lm else None),
            nbytes(enc_h, comp_h, enc_lens, *ws, *(lm_ws if use_lm else ()))
            + 4 * B * MAX_STEPS)  # the int32 tokens
        out[name].update(ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by)
    return out


def eos_biased(torch, model, bias):
    """A copy of ``model`` whose EOS logit carries ``bias``."""
    from ss_asr_tpu_torch.vocab import EOS_ID

    m = copy.deepcopy(model)
    with torch.no_grad():
        m.char_trans.bias[EOS_ID] = bias
    return m


def first_divergence(got, want):
    """{row: the first step at which two frontiers' tokens or parents
    differ}; got / want are (toks, parents, ...) numpy [T, B, K]."""
    neq = ((got[0] != want[0]) | (got[1] != want[1])).any(-1)
    return {b: int(neq[:, b].nonzero()[0][0]) for b in range(neq.shape[1]) if neq[:, b].any()}


def check_beam(torch, rng, model, lm):
    """K8 against beam_scan_plain: the seeded frontier, the early exit, and
    the times over all 200 steps.  K = 3 and 8 by the near-tie rule; K = 16
    by the rows that part from the plain version other than at a float32
    tie, at most MAX_NEAR_TIE_ROWS beyond the one-block kernel's count on
    the same inputs (another float32 order of the same frontier), every
    parting at a plain near tie, with the final scores compared on the rows
    that never part.  Every width by the replay of the kernel's own path on
    every row."""
    import numpy as np

    from ss_asr_tpu_torch.models import las
    from ss_asr_tpu_torch.ops.kernels import beam as kbeam
    from ss_asr_tpu_torch.vocab import EOS_ID

    from ss_asr_tpu_torch.ops.kernels.decode import lm_operands, speller_operands

    enc_h, comp_h, enc_lens = listener_memory(torch, rng, model, B)
    ws, lm_ws = speller_operands(model, enc_h.device), lm_operands(lm, enc_h.device)
    V = model.cfg.vocab_size
    # the float64 witness of near-tied divergences
    model64, lm64 = copy.deepcopy(model).double(), copy.deepcopy(lm).double()
    with torch.inference_mode():
        enc64 = enc_h.double()
        comp64 = las.attention_precompute(model64.attention, enc64)
    out, wide = {}, {}
    for name, use_lm in (("beam_decode", False), ("beam_decode_lm", True)):
        lm_, lm64_ = (lm, lm64) if use_lm else (None, None)
        errs, near_rows, tie_rows = [], 0, 0
        for K in BEAM_WIDTHS:
            tag = f"{name} K={K}"
            with torch.inference_mode():
                before = kbeam.LAUNCHES[f"{name}_cluster"]
                got_t = kbeam.beam_device(model, enc_h, comp_h, enc_lens, K, MAX_STEPS, lm_, 0.5)
                torch.cuda.synchronize()
                route = kbeam.beam_route(*beam_dims(model, lm_), enc_h.shape[1], K, B)
                if route[0] == 0 or kbeam.LAUNCHES[f"{name}_cluster"] != before + 1:
                    fail(f"{tag}: route by shape {route}, "
                         f"{kbeam.LAUNCHES[f'{name}_cluster'] - before} cluster launches: the "
                         "kernel phase's widths must take the cluster route")
                again = kbeam.beam_device(model, enc_h, comp_h, enc_lens, K, MAX_STEPS, lm_, 0.5)
                if not all(torch.equal(a, b) for a, b in zip(got_t, again)):
                    fail(f"{tag}: two runs differ")
                want_t = kbeam.beam_scan_plain(model, enc_h, comp_h, enc_lens, K, MAX_STEPS,
                                               lm_, 0.5)
                plain_c = replay_frontier(torch, model, lm_, 0.5, enc_h, comp_h, enc_lens,
                                          *want_t[:2])[0]
                gaps = frontier_gaps(torch, plain_c, K, MAX_STEPS)
                kern_c, k_scores, k_done, k_hyp = replay_frontier(
                    torch, model, lm_, 0.5, enc_h, comp_h, enc_lens, *got_t[:2])
            got, want = [t.cpu().numpy() for t in got_t], [t.cpu().numpy() for t in want_t]
            c64 = []

            def f32_tie(b, d, front=got):
                """The plain and the kernel's (``front``'s) candidates at the
                first slot where row b's step d differs, in float64 along the
                plain path."""
                if not c64:
                    with torch.inference_mode():
                        c64.append(replay_frontier(torch, model64, lm64_, 0.5, enc64, comp64,
                                                   enc_lens, *want_t[:2])[0].cpu().numpy())
                slot = int(((front[0][d, b] != want[0][d, b])
                            | (front[1][d, b] != want[1][d, b])).nonzero()[0][0])
                c = c64[0][b, d]
                mine = c[want[1][d, b, slot] * V + want[0][d, b, slot]]
                theirs = c[front[1][d, b, slot] * V + front[0][d, b, slot]]
                res = F32_TIE_ULPS * float(np.spacing(np.float32(abs(mine))))
                err32 = abs(float(plain_c[b, d, want[1][d, b, slot] * V
                                          + want[0][d, b, slot]]) - mine)
                return abs(mine - theirs) <= min(res, NEAR_TIE), (
                    f"slot {slot}: float64 gap {abs(mine - theirs):.3e}, float32 resolution "
                    f"({F32_TIE_ULPS} ulps) {res:.3e}, plain float32 error {err32:.3e}")

            def steps(f):  # [B, T, 2, K]: each step's tokens and parents
                return np.stack([f[0], f[1]], -2).transpose(1, 0, 2, 3)

            faults = []  # K = 16: failed after the own path's replay has printed
            if K <= 8:
                near, ties, compared = compare_tokens(tag, steps(got), steps(want), gaps, f32_tie)
                whole = compared.all(1)
            else:
                with torch.inference_mode():
                    one = [t.cpu().numpy() for t in kbeam.beam_device(
                        model, enc_h, comp_h, enc_lens, K, MAX_STEPS, lm_, 0.5, route=(0, 0))]
                parted = {}  # route -> (rows that part, rows that part other than at a float32 tie)
                for who, front in (("cluster", got), ("one-block", one)):
                    div, off = first_divergence(front, want), []
                    for b, d in sorted(div.items()):
                        tie, why = f32_tie(b, d, front)
                        off += [] if tie else [b]
                        print(f"{tag} {who}: row {b} parts from the plain version at step {d}, "
                              f"plain gap {gaps[b, d]:.3e}; {why}"
                              f"{'' if tie else '; not a float32 tie'}", flush=True)
                        if gaps[b, d] >= NEAR_TIE:
                            faults.append(f"{tag} {who}: row {b} parts at step {d} where the "
                                          f"plain gap is {gaps[b, d]:.3e}")
                    parted[who] = (div, off)
                (div, off), (div_one, off_one) = parted["cluster"], parted["one-block"]
                print(f"{tag}: rows that part from the plain version: the cluster route "
                      f"{len(div)} of {B}, {len(off)} of them not at a float32 tie; the one-block "
                      f"kernel {len(div_one)}, {len(off_one)} (at most "
                      f"{len(off_one) + MAX_NEAR_TIE_ROWS} not at a float32 tie)", flush=True)
                if len(off) > len(off_one) + MAX_NEAR_TIE_ROWS:
                    faults.append(f"{tag}: {len(off)} rows part from the plain version other "
                                  f"than at a float32 tie, more than the one-block kernel's "
                                  f"{len(off_one)} + {MAX_NEAR_TIE_ROWS}")
                whole = np.array([b not in div for b in range(B)])
                wide[name] = {"diverged_rows": len(div), "diverged_off_f32_tie": len(off),
                              "one_block_diverged_rows": len(div_one),
                              "one_block_diverged_off_f32_tie": len(off_one)}
            err = float(np.abs(got[2] - want[2])[whole].max(initial=0.0))
            if not (err <= SCORE_TOL and (got[3] == want[3])[whole].all()
                    and (got[4] == want[4])[whole].all()):
                fail(f"{tag}: final scores differ by {err} (> {SCORE_TOL}) or done / lengths "
                     "differ on rows that never diverged")
            # every row, diverged or not: the kernel's own path replayed
            # through the plain step picks, at each step, candidates within
            # SCORE_TOL of the step's K best and ends at the kernel's scores
            n = kern_c.shape[1]
            picks = (got_t[1][:n].long() * V + got_t[0][:n].long()).permute(1, 0, 2)
            pick_err = float((torch.gather(kern_c, 2, picks)
                              - torch.topk(kern_c, K, dim=-1).values).abs().max())
            path_err = float((got_t[2] - k_scores).abs().max())
            if not (pick_err <= SCORE_TOL and path_err <= SCORE_TOL
                    and torch.equal(got_t[3], k_done) and torch.equal(got_t[4], k_hyp)):
                fail(f"{tag}: along its own path the kernel's picks are off the step's K best "
                     f"by {pick_err}, its scores by {path_err} (> {SCORE_TOL}), or its done / "
                     "lengths differ from the plain step's")
            print(f"{tag} B={B} S={enc_h.shape[1]} (cluster route {route}): "
                  f"seeded run of {plain_c.shape[1]} steps, final "
                  f"score max_abs_err {err:.3e} on {int(whole.sum())} whole rows; the kernel's "
                  f"own path replayed: picks within {pick_err:.3e} of the K best, scores within "
                  f"{path_err:.3e}, done and lengths equal, all {B} rows", flush=True)
            if faults:
                fail("; ".join(faults))
            errs.append(max(err, path_err))
            if K <= 8:
                near_rows += near
                tie_rows += ties
        out[name] = {"max_abs_err": max(errs), "near_tie_rows": near_rows,
                     "float32_tie_rows": tie_rows, "k16": wide[name]}

    # early exit: with an EOS bias of +50 every beam ends within two steps
    ended = eos_biased(torch, model, 50.0)
    for K in BEAM_WIDTHS:
        for lm_ in (None, lm):
            with torch.inference_mode():
                got = kbeam.beam_device(ended, enc_h, comp_h, enc_lens, K, MAX_STEPS, lm_, 0.5)
                want = kbeam.beam_scan_plain(ended, enc_h, comp_h, enc_lens, K, MAX_STEPS, lm_,
                                             0.5)
            got, want = [t.cpu().numpy() for t in got], [t.cpu().numpy() for t in want]
            same = all((g == w).all() for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]))
            if not (same and got[3].all() and (got[0][2:] == 0).all()
                    and np.abs(got[2] - want[2]).max() <= SCORE_TOL):
                fail(f"beam early exit K={K} lm={lm_ is not None}: differs from the plain "
                     "frontier or did not end within two steps")
    print("beam early exit (EOS bias 50): every beam ends within two steps, then SOS and "
          "identity parents; equal to the plain frontier", flush=True)

    # per-step cost: an EOS bias of -50 keeps every beam open all MAX_STEPS
    running = eos_biased(torch, model, -50.0)
    for name, lm_ in (("beam_decode", None), ("beam_decode_lm", lm)):
        for K in BEAM_WIDTHS:
            with torch.inference_mode():
                k_ms = cuda_ms(torch, lambda: kbeam.beam_device(
                    running, enc_h, comp_h, enc_lens, K, MAX_STEPS, lm_, 0.5))
                p_ms = cuda_ms(torch, lambda: kbeam.beam_scan_plain(
                    running, enc_h, comp_h, enc_lens, K, MAX_STEPS, lm_, 0.5), reps=3)
                front = kbeam.beam_device(running, enc_h, comp_h, enc_lens, K, MAX_STEPS, lm_, 0.5)
                toks = front[0]
            if bool((toks == EOS_ID).any()):
                fail(f"{name} K={K}: an EOS bias of -50 still emitted EOS")
            use = lm_ws if lm_ is not None else None
            b_ms, b_by = bound(B * K * MAX_STEPS * speller_row_ops(ws, enc_h.shape[1], use),
                               nbytes(enc_h, comp_h, enc_lens, *front, *ws, *(use or ())))
            print(f"{name} K={K} full {MAX_STEPS} steps B={B} S={enc_h.shape[1]}: kernel "
                  f"{k_ms:.3f} ms ({1e3 * k_ms / MAX_STEPS:.1f} us/step), plain {p_ms:.3f} ms "
                  f"({1e3 * p_ms / MAX_STEPS:.1f} us/step), bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
            if K == BEAM_WIDTHS[0]:  # the default config's width goes into the JSON
                out[name].update(ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                                 bound_by=b_by)
            elif K > 8:
                out[name]["k16"].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
    beam_routes(torch, running, lm, enc_h, comp_h, enc_lens)
    return out


def beam_dims(model, lm):
    """(H, F, M, V, HL) of the beam search's shape, HL = 0 without an LM."""
    cfg = model.cfg
    return (cfg.decoder_state_size, cfg.enc_out_dim, cfg.mlp_out_size, cfg.vocab_size,
            lm.cfg.hidden_size if lm is not None else 0)


def beam_routes(torch, model, lm, enc_h, comp_h, enc_lens):
    """K8's routes timed over all MAX_STEPS steps (``model`` never emits EOS):
    the cluster route by shape, the other utterance count a cluster that
    serves the shape, and the one-block kernel, at the kernel phase's
    batch and at the server batch of 8 (at K above 8 also at B = 1, a
    ``?nbest`` request), each batch beside its bound; then long memory (S =
    1000 and 1500, B = 8, K = 3 + LM) on the route by shape and the
    one-block kernel."""
    import numpy as np

    from ss_asr_tpu_torch.models import las
    from ss_asr_tpu_torch.ops.kernels import beam as kbeam
    from ss_asr_tpu_torch.ops.kernels.decode import lm_operands, speller_operands

    cfg = model.cfg
    H, F, M, V = cfg.decoder_state_size, cfg.enc_out_dim, cfg.mlp_out_size, cfg.vocab_size
    HL = lm.cfg.hidden_size
    ws, lm_ws = speller_operands(model, enc_h.device), lm_operands(lm, enc_h.device)
    for K in BEAM_WIDTHS:
        for lm_ in (None, lm):
            for Bn in (B, N_REQUESTS) + ((1,) if K > 8 else ()):
                mem = tuple(t[:Bn].contiguous() for t in (enc_h, comp_h, enc_lens))
                S = mem[0].shape[1]
                hl = HL if lm_ else 0
                by_shape = kbeam.beam_route(H, F, M, V, hl, S, K, Bn)
                C = 4 * H // kbeam.STREAM_WIDTH
                routes = [by_shape] + [(C, u) for u in (1, 2) if (C, u) != by_shape
                                       and kbeam.cluster_plan(H, F, M, V, hl, S, K, C, u)]
                routes += [(0, 0)] if by_shape != (0, 0) else []
                with torch.inference_mode():
                    times = {r: cuda_ms(torch, lambda: kbeam.beam_device(
                        model, *mem, K, MAX_STEPS, lm_, 0.5, route=r)) for r in routes}
                use = lm_ws if lm_ is not None else None
                # inputs once; the int32 tokens and parents and the three [B, K] outputs once
                b_ms, b_by = bound(Bn * K * MAX_STEPS * speller_row_ops(ws, S, use),
                                   nbytes(*mem, *ws, *(use or ())) + 4 * Bn * K * (2 * MAX_STEPS + 3))
                print(f"beam K={K} lm={lm_ is not None} B={Bn} S={S} {MAX_STEPS} steps, route "
                      f"(C, U) by shape {by_shape}: " + ", ".join(
                          f"{r} {ms:.3f} ms ({1e3 * ms / MAX_STEPS:.1f} us/step)"
                          for r, ms in times.items()) + f"; bound {b_ms:.4f} ms ({b_by})",
                      flush=True)
    rng = np.random.default_rng(SEED + 7)
    for S in (1000, 1500):
        enc = torch.from_numpy(rng.standard_normal((N_REQUESTS, S, F)).astype("float32")).to(DEVICE)
        lens = torch.from_numpy(rng.integers(S // 2, S + 1, N_REQUESTS).astype("int32")).to(DEVICE)
        with torch.inference_mode():
            comp = las.attention_precompute(model.attention, enc)
            by_shape = kbeam.beam_route(H, F, M, V, HL, S, 3, N_REQUESTS)
            times = {r: cuda_ms(torch, lambda: kbeam.beam_device(
                model, enc, comp, lens, 3, MAX_STEPS, lm, 0.5, route=r), reps=3)
                for r in (by_shape, (0, 0))}
        print(f"beam K=3 lm=True B={N_REQUESTS} S={S} {MAX_STEPS} steps: " + ", ".join(
            f"route {r} {ms:.3f} ms ({1e3 * ms / MAX_STEPS:.1f} us/step)"
            for r, ms in times.items()), flush=True)


def spell_routes(kspell, shape_route):
    """Every route of K9 / K10 a shape could take: each tile height the
    cluster route serves, then the one-row kernels (0); the route by shape
    first."""
    return [shape_route] + [r for r in kspell.TILE_ROWS + (0,) if r != shape_route]


def check_spell(torch, rng, model):
    """K9 against spell_fwd_plain at the training flagship, the TAE step's
    shape and the alignment shape, teacher-forced, sampled and greedy, on
    the route by shape (the cluster route, with the gates it writes for
    K10); the one-row kernels too at tf 0.9; every route timed."""
    from ss_asr_tpu_torch.models import las
    from ss_asr_tpu_torch.ops.kernels import spell as kspell
    from ss_asr_tpu_torch.ops.kernels.decode import speller_operands
    from ss_asr_tpu_torch.vocab import VOCAB_SIZE

    enc_all, comp_all, lens_all = listener_memory(torch, rng, model,
                                                  max(b for b, _, _ in SPELL_SHAPES))
    cfg = model.cfg
    res = {"max_abs_err": 0.0}
    for Bs, L, S in SPELL_SHAPES:
        enc_h, comp_h = enc_all[:Bs, :S].contiguous(), comp_all[:Bs, :S].contiguous()
        enc_lens = torch.clamp(lens_all[:Bs], max=S)
        by_shape = kspell.spell_route(Bs, cfg.decoder_state_size, cfg.enc_out_dim,
                                      cfg.mlp_out_size, S, VOCAB_SIZE)
        if by_shape not in kspell.TILE_ROWS:
            fail(f"spell_fwd B={Bs} L={L} S={S}: the route by shape is {by_shape}, not the cluster")
        for tf in (1.0, 0.9, None):
            g = torch.Generator().manual_seed(SEED)
            if tf is None:  # greedy feedback
                tf_draws = torch.zeros(L, device=DEVICE)
                gumbel = torch.zeros(L, Bs, VOCAB_SIZE, device=DEVICE)
            else:
                tf_draws, gumbel = las.draw_scheduled_sampling(L, Bs, tf, model.cfg, g,
                                                               device=DEVICE)
            ids = torch.randint(0, VOCAB_SIZE, (L, Bs), generator=g).to(DEVICE)
            args = (model, enc_h, comp_h, enc_lens, tf_draws, gumbel, model.embed.weight[ids])
            mode = "greedy" if tf is None else f"tf {tf} ({int(tf_draws.sum())}/{L} teacher)"
            with torch.inference_mode():
                want = kspell.spell_fwd_plain(*args, with_gates=True)
                for route in ([by_shape, 0] if tf == 0.9 else [by_shape]):
                    zero_launches()
                    got = kspell.spell_fwd(*args, with_gates=True, route=route)
                    torch.cuda.synchronize()
                    took = read_launches()
                    if took["spell_fwd"] != 1 or took["spell_fwd_cluster"] != int(route > 0):
                        fail(f"spell_fwd route {route}: launches {took}")
                    pairs = list(zip(got, want)) if route else list(zip(got[:7], want[:7]))
                    err = max(float((a - b).abs().max()) for a, b in pairs)
                    print(f"spell_fwd B={Bs} L={L} S={S} {mode} route {route}: "
                          f"{len(pairs)} streams max_abs_err {err:.3e}", flush=True)
                    if not err <= SPELL_TOL:
                        fail(f"spell_fwd B={Bs} L={L} {mode} route {route}: max_abs_err {err} > "
                             f"{SPELL_TOL}")
                    res["max_abs_err"] = max(res["max_abs_err"], err)
                if tf != 0.9:
                    continue
                times = {r: cuda_ms(torch, lambda: kspell.spell_fwd(*args, with_gates=r > 0,
                                                                    route=r))
                         for r in spell_routes(kspell, by_shape)}
                p_ms = cuda_ms(torch, lambda: kspell.spell_fwd_plain(*args), reps=3)
            ws = speller_operands(model, enc_h.device)
            b_ms, b_by = bound(Bs * L * speller_row_ops(ws, S),  # the streams and the gates
                               nbytes(*args[1:], *ws, *want))
            print(f"spell_fwd B={Bs} L={L} S={S} {mode}: " + ", ".join(
                f"route {r} {ms:.3f} ms" for r, ms in times.items())
                + f"; plain {p_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by}); by shape "
                f"{times[by_shape] / L * 1e3:.1f} us/step", flush=True)
            if (Bs, L) == (TRAIN_B, TRAIN_L):  # the train step's shape and rate
                res.update(ms=times[by_shape], plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                           bound_by=b_by)
    return {"spell_fwd": res}


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


def launch_counters():
    """Every kernel wrapper's launch counter."""
    from ss_asr_tpu_torch.ops.kernels import beam as kbeam
    from ss_asr_tpu_torch.ops.kernels import decode as kdec
    from ss_asr_tpu_torch.ops.kernels import frontend as kfe
    from ss_asr_tpu_torch.ops.kernels import lstm as klstm
    from ss_asr_tpu_torch.ops.kernels import spell as kspell

    return (klstm.LAUNCHES, kdec.LAUNCHES, kbeam.LAUNCHES, kspell.LAUNCHES, kfe.LAUNCHES)


def zero_launches():
    for c in launch_counters():
        for k in c:
            c[k] = 0


def read_launches():
    return {k: v for c in launch_counters() for k, v in c.items()}


#: the kernels with a cluster route, and the counter of their cluster launches
CLUSTER_COUNTERS = {name: f"{name}_cluster"
                    for name in ("lstm_fwd", "lstm_bwd", "greedy_decode", "greedy_decode_lm",
                                 "beam_decode", "beam_decode_lm", "spell_fwd", "spell_bwd")}


def require_cluster_route(path, launches):
    """Every launch of a kernel with a cluster route on ``path`` took it."""
    for name, counter in CLUSTER_COUNTERS.items():
        if launches[counter] != launches[name]:
            fail(f"{path}: {launches[counter]} of {launches[name]} {name} launches took the "
                 "cluster route")


@contextlib.contextmanager
def serving(t, reload_paths=None, sr=SR):
    """The port's HTTP server over a signal-mode batcher of ``t`` at ``sr``,
    in this process on a free local port -> ``post(path, body) -> (status,
    json)``."""
    from ss_asr_tpu_torch.serve import BatchingTranscriber, serve_http

    ready = threading.Event()
    with BatchingTranscriber(t, max_batch=8, max_wait_ms=1000, mode="signal", sr=sr) as bt:
        server = serve_http(bt, host="127.0.0.1", port=0, ready_event=ready,
                            reload_paths=reload_paths)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        # the server is local: never route its requests through an environment proxy
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

        def post(path, body=b""):
            try:
                with opener.open(urllib.request.Request(base + path, data=body),
                                 timeout=300) as r:
                    return r.status, json.load(r)
            except urllib.error.HTTPError as e:
                return e.code, json.load(e)

        try:
            yield post
        finally:
            server.shutdown()
            server.server_close()
            th.join(timeout=30)


def serve_phase(torch, tag, t, sigs, need, reload_paths=None, routes=(), sr=SR,
                min_chars=MAX_STEPS // 4):
    """Concurrent POST /transcribe of ``sigs`` (WAVs at ``sr``) against the
    direct batch, the replies at least ``min_chars`` characters long on
    average (so that the decodes run, not stop at their first step), then
    each route of ``routes``: (name, fn(post), kernels it must launch), fn
    sending the route's requests and checking each reply against an
    expectation computed before the server started.

    The launch counters are zeroed just before each path's requests (after
    one warm-up request) and read just after its last reply, so each count
    is that path's own; every kernel of ``need`` (the batch) and of each
    route must have launched.  Last, a torch.profiler split of three direct
    batches.  Returns {path: launches}."""
    from ss_asr_tpu_torch.data.audio import read_wav

    bodies = [wav_bytes(s, sr) for s in sigs]
    # the server's signals are the WAVs' int16 samples read back
    signals = [read_wav(io.BytesIO(b))[1] for b in bodies]
    direct = t.transcribe_signal_batch(signals, sr=sr)
    launches = {}
    with serving(t, reload_paths, sr) as post:
        post("/transcribe", bodies[0])  # warm-up: lazy CUDA/cuBLAS set-up, not steady state
        zero_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(N_REQUESTS) as ex:
            replies = list(ex.map(lambda b: post("/transcribe", b), bodies))
        secs = time.perf_counter() - t0
        launches[tag] = read_launches()
        for name, fn, _ in routes:
            zero_launches()
            fn(post)
            launches[f"{tag} {name}"] = read_launches()
    for i, (status, obj) in enumerate(replies):
        if status != 200 or "text" not in obj:
            fail(f"{tag}: request {i} answered {status} {obj}")
        if obj["text"] != direct[i]:
            fail(f"{tag}: request {i} text {obj['text']!r} != direct {direct[i]!r}")
    chars = statistics.mean(len(o["text"]) for _, o in replies)
    print(f"{tag}: {len(replies)} requests, all 200, texts equal the direct batch, {chars:.1f} "
          f"characters a reply (first {replies[0][1]['text'][:40]!r}); {secs:.3f} s, "
          f"{len(replies) / secs:.3f} utt/s", flush=True)
    if chars < min_chars:
        fail(f"{tag}: {chars:.1f} characters a reply, fewer than {min_chars}")
    for path, names in [(tag, need)] + [(f"{tag} {n}", k) for n, _, k in routes]:
        print(f"{path}: launches {launches[path]}", flush=True)
        for name in names:
            if launches[path][name] < 1:
                fail(f"{path}: launched {name} {launches[path][name]} times")
        require_cluster_route(path, launches[path])
    # where a steady batch's time goes: the direct call, outside the launch counts
    print(f"{tag}: one direct batch of {len(signals)} signals, torch.profiler:", flush=True)
    profile_steps(torch, lambda: t.transcribe_signal_batch(signals, sr=sr), 3)
    return launches


def default_routes(torch, t, config, paths, sig, long_sig, stream_sig, new_asr_tree):
    """The detail, long-form, stream and reload routes of a server over
    ``t`` (beam 3 + LM), as serve_phase takes them.  Every expectation is
    the direct call, made here, before the server starts."""
    import numpy as np

    from ss_asr_tpu_torch.api import Transcriber
    from ss_asr_tpu_torch.data.audio import read_wav
    from ss_asr_tpu_torch.ops.frontend import compute_fbank
    from ss_asr_tpu_torch.streaming import StreamingTranscriber
    from ss_asr_tpu_torch.utils.checkpoint import save_pytree

    def check(what, ok, got):
        if not ok:
            fail(f"serve default: {what}: {got}")

    body = wav_bytes(sig, SR)
    y = read_wav(io.BytesIO(body))[1]
    fb = compute_fbank(y, SR, device=DEVICE)
    want = t.transcribe_fbank_detailed(fb, n_best=3)[0]
    # ?nbest above 8 decodes with the 16-row cluster variant
    want16 = t.transcribe_fbank_detailed(fb, n_best=16)[0]
    long_body = wav_bytes(long_sig, SR)
    y_long = read_wav(io.BytesIO(long_body))[1]
    want_long = t.transcribe_long(y_long, SR)
    pcm = (np.clip(stream_sig, -1, 1) * 32767).astype("<i2")
    chunks = np.array_split(pcm, max(1, len(pcm) // (SR // 2)))
    ref = StreamingTranscriber(t, sr=SR)
    want_partials = []
    for c in chunks:
        ref.feed(c.astype(np.float32) / 32768.0)
        want_partials.append({"partial": ref.partial(), "committed": ref.committed_text})
    want_final = {"text": ref.finalize()}
    save_pytree(paths["new_asr"], new_asr_tree)
    fresh = Transcriber.from_checkpoint(paths["new_asr"], config, lm_path=paths["lm"],
                                        device=DEVICE, max_steps=MAX_STEPS, sr=SR)
    want_fresh = {"text": fresh.transcribe_signal(y, SR)}

    def detail(post):
        code, obj = post("/transcribe?detail=1&nbest=3", body)
        check("?detail=1&nbest=3", code == 200 and [h["text"] for h in obj["hypotheses"]]
              == [h.text for h in want] and all(
                  abs(g["score"] - h.score) <= 1e-4 and len(g["char_starts"]) == len(h.text)
                  for g, h in zip(obj["hypotheses"], want)), (code, obj))
        print(f"serve default: ?detail=1&nbest=3 200, {len(want)} hypotheses equal the direct "
              f"call (best {len(want[0].text)} chars, score {want[0].score:.3f})", flush=True)

    def detail16(post):
        code, obj = post("/transcribe?detail=1&nbest=16", body)
        check("?detail=1&nbest=16", code == 200 and len(want16) == 16
              and [h["text"] for h in obj["hypotheses"]] == [h.text for h in want16] and all(
                  abs(g["score"] - h.score) <= 1e-4 for g, h in zip(obj["hypotheses"], want16)),
              (code, obj))
        print(f"serve default: ?detail=1&nbest=16 200, {len(want16)} hypotheses equal the direct "
              f"call (best {len(want16[0].text)} chars, score {want16[0].score:.3f})", flush=True)

    def long(post):
        t0 = time.perf_counter()
        code, obj = post("/transcribe?long=1", long_body)
        secs = time.perf_counter() - t0
        check("?long=1", code == 200 and obj["text"] == want_long, (code, obj))
        print(f"serve default: ?long=1 on {len(y_long) / SR:.1f} s, 200 in {secs:.3f} s, "
              f"{len(want_long)} chars, equal to the direct call", flush=True)

    def stream(post):
        code, obj = post("/stream")
        check("/stream create", code == 200 and "id" in obj, (code, obj))
        sid = obj["id"]
        for c, w in zip(chunks, want_partials):
            code, obj = post(f"/stream/{sid}", c.tobytes())
            check("/stream feed", (code, obj) == (200, w), (code, obj))
        code, obj = post(f"/stream/{sid}/end")
        check("/stream end", (code, obj) == (200, want_final), (code, obj))
        print(f"serve default: /stream of {len(pcm) / SR:.1f} s in {len(chunks)} PCM16 chunks, "
              "every partial and the final text equal the direct session", flush=True)

    def reload(post):
        shutil.copyfile(paths["new_asr"], paths["asr"])
        code, obj = post("/reload")
        check("/reload", code == 200, (code, obj))
        code, obj = post("/transcribe", body)
        check("/transcribe after /reload", (code, obj) == (200, want_fresh), (code, obj))
        print("serve default: /reload 200; the next reply equals a transcriber loaded from the "
              "new checkpoint", flush=True)

    dec = ("fbank", "lstm_fwd", "beam_decode_lm")
    return [("?detail", detail, dec + ("spell_fwd",)),
            ("?nbest=16", detail16, dec + ("spell_fwd",)), ("?long", long, dec),
            ("/stream", stream, dec), ("/reload", reload, dec)]


def long_signal(rng, seconds):
    """A seeded tone-and-noise signal with quiet gaps every few seconds."""
    import numpy as np

    n = int(seconds * SR)
    t = np.arange(n) / SR
    y = sum(0.2 * np.sin(2 * np.pi * f * t) for f in rng.uniform(100, 3000, size=3))
    y = y + 0.05 * rng.standard_normal(n)
    for start in np.arange(2.5, seconds, 4.0):
        y[int(start * SR) : int((start + 0.3) * SR)] *= 0.02
    return y.astype(np.float32)


def rel_l2(torch, a, ref) -> float:
    """||a - ref|| / ||ref||, in float64."""
    a, ref = a.double(), ref.double()
    return float((a - ref).norm() / ref.norm().clamp(min=1e-30))


def anchored(torch, name, kernel, plain, ref64):
    """The float64-anchored rule: the kernel's relative L2 error against a
    float64 run of the plain version at most ANCHOR_RATIO times the plain
    float32 version's own, and at most ANCHOR_MAX.  Returns the kernel's."""
    k, p = rel_l2(torch, kernel, ref64), rel_l2(torch, plain, ref64)
    print(f"{name}: rel L2 vs float64 plain: kernel {k:.3e}, plain float32 {p:.3e}", flush=True)
    if not (k <= ANCHOR_RATIO * p and k <= ANCHOR_MAX):
        fail(f"{name}: kernel error {k:.3e} against float64 exceeds {ANCHOR_RATIO} x the plain "
             f"version's {p:.3e} or {ANCHOR_MAX}")
    return k


def check_lstm_bwd(torch, rng, asr_tree):
    """K3 against lstm_bwd_plain on the four listener layers' shapes (B =
    TRAIN_B, both directions, ragged lengths including 0 and 1): dgx and
    dW_hh by the float64-anchored rule, on the cluster route (its launch
    counter must say so).  Then the same rule at a small cluster (H = 128:
    two CTAs) and at a shape that takes the streaming route (H = 384), and
    the first layer's time at every tile height of the cluster route."""
    import numpy as np

    from ss_asr_tpu_torch.ops.kernels import lstm as klstm

    def plain(gx, whh, lengths, y, cs, dy, rev):
        dgx = torch.stack([klstm.lstm_bwd_plain(gx[d], whh[d], lengths, y[d], cs[d], dy[d], rev[d])
                           for d in range(2)])
        dwhh = torch.stack([torch.einsum("tbh,tbg->hg", klstm.predecessors(y[d], rev[d]), dgx[d])
                            for d in range(2)])
        return dgx, dwhh

    def operands(whh, T, Bn):
        Hn = whh.shape[1]
        gx = torch.from_numpy(rng.standard_normal((2, T, Bn, 4 * Hn)).astype("float32")).to(DEVICE)
        dy = torch.from_numpy(rng.standard_normal((2, T, Bn, Hn)).astype("float32")).to(DEVICE)
        lens = rng.integers(2, T + 1, size=Bn)
        lens[:3] = (0, 1, T)
        return gx, dy, torch.from_numpy(lens.astype("int32")).to(DEVICE)

    H = asr_tree["encoder"]["blstm4"]["fwd"]["w_hh"].shape[0]
    err_max, ms, plain_ms, lib_ms, ops, moved = 0.0, 0.0, 0.0, 0.0, 0.0, 0
    rev = (False, True)
    route = klstm.lstm_bwd_route(H, TRAIN_B, 2)
    if route[0] == 0:
        fail(f"lstm_bwd: H={H} B={TRAIN_B} takes the streaming route, not a cluster")
    held = klstm.resident_clusters(H, route[0], route[1], DEVICE)
    print(f"lstm_bwd H={H} B={TRAIN_B}: clusters of {route[0]} CTAs, tiles of {route[1]} rows: "
          f"{-(-TRAIN_B // route[1]) * 2} clusters, of which the card holds {held} at once "
          f"(the route's table says {klstm.CARD_CLUSTERS[route[0]]})", flush=True)
    for layer, T in zip(("pblstm1", "pblstm2", "pblstm3", "blstm4"),
                        (FRAMES, FRAMES // 2, FRAMES // 4, FRAMES // 8)):
        p = asr_tree["encoder"][layer]
        whh = torch.from_numpy(np.stack([p["fwd"]["w_hh"], p["bwd"]["w_hh"]])).to(DEVICE)
        gx, dy, lengths = operands(whh, T, TRAIN_B)
        with torch.no_grad():
            y, cs = klstm.lstm_fwd(gx, whh, lengths, rev)
            before = klstm.LAUNCHES["lstm_bwd_cluster"]
            got = klstm.lstm_bwd(gx, whh, lengths, y, cs, dy, rev)
            torch.cuda.synchronize()
            if klstm.LAUNCHES["lstm_bwd_cluster"] != before + 1:
                fail(f"lstm_bwd {layer}: the flagship shape did not take the cluster route")
            want = plain(gx, whh, lengths, y, cs, dy, rev)
            ref = plain(*(t.double() for t in (gx, whh)), lengths,
                        *(t.double() for t in (y, cs, dy)), rev)
            for name, g, w, r in zip(("dgx", "dW_hh"), got, want, ref):
                anchored(torch, f"lstm_bwd {layer} T={T} B={TRAIN_B} {name}", g, w, r)
            k_ms = cuda_ms(torch, lambda: klstm.lstm_bwd(gx, whh, lengths, y, cs, dy, rev))
            p_ms = cuda_ms(torch, lambda: plain(gx, whh, lengths, y, cs, dy, rev), reps=3)
        err = float((got[0] - want[0]).abs().max())
        l_ms = cudnn_lstm_ms(torch, p["fwd"]["w_ih"].shape[0], H, T, TRAIN_B, backward=True)
        print(f"lstm_bwd {layer} T={T} B={TRAIN_B} H={H} 2 dirs (cluster of {route[0]}, tiles of "
              f"{route[1]} rows): dgx max_abs_err {err:.3e}; kernel {k_ms:.3f} ms "
              f"({k_ms / T * 1e3:.2f} us per step with the dW_hh product) plain {p_ms:.3f} ms "
              f"cuDNN nn.LSTM forward + backward {l_ms:.3f} ms", flush=True)
        if layer == "pblstm1":
            with torch.no_grad():
                alt = {r: cuda_ms(torch, lambda: klstm.lstm_bwd(gx, whh, lengths, y, cs, dy, rev,
                                                                 route=(route[0], r)))
                       for r in klstm.TILE_ROWS}
                old = cuda_ms(torch, lambda: klstm.lstm_bwd(gx, whh, lengths, y, cs, dy, rev,
                                                            route=(0, 0)))
            print(f"lstm_bwd {layer}: tiles of "
                  + ", ".join(f"{r} rows {ms_r:.3f} ms" for r, ms_r in alt.items())
                  + f"; the streaming route {old:.3f} ms", flush=True)
        err_max = max(err_max, err)
        ms += k_ms
        plain_ms += p_ms
        lib_ms += l_ms
        # the gate recompute, dgates @ W_hh^T and the dW_hh product, then the cell's adjoint
        ops += 2 * T * TRAIN_B * (3 * 8.0 * H * H + 40 * H)
        moved += nbytes(gx, whh, lengths, y, cs, dy, *got)
    # the other routes: a small cluster, and a shape that no cluster serves
    for Hn, T, Bn in ((128, 64, 13), (384, 32, 9)):
        whh = torch.from_numpy((rng.standard_normal((2, Hn, 4 * Hn)) / np.sqrt(Hn))
                               .astype("float32")).to(DEVICE)
        gx, dy, lengths = operands(whh, T, Bn)
        r = klstm.lstm_bwd_route(Hn, Bn, 2)
        with torch.no_grad():
            y, cs = klstm.lstm_fwd(gx, whh, lengths, rev)
            before = klstm.LAUNCHES["lstm_bwd_cluster"]
            got = klstm.lstm_bwd(gx, whh, lengths, y, cs, dy, rev)
            torch.cuda.synchronize()
            took = klstm.LAUNCHES["lstm_bwd_cluster"] - before
            want = plain(gx, whh, lengths, y, cs, dy, rev)
            ref = plain(*(t.double() for t in (gx, whh)), lengths,
                        *(t.double() for t in (y, cs, dy)), rev)
            tag = f"cluster of {r[0]}, tiles of {r[1]} rows" if r[0] else "streaming route"
            for name, g, w, r64 in zip(("dgx", "dW_hh"), got, want, ref):
                anchored(torch, f"lstm_bwd H={Hn} T={T} B={Bn} ({tag}) {name}", g, w, r64)
            k_ms = cuda_ms(torch, lambda: klstm.lstm_bwd(gx, whh, lengths, y, cs, dy, rev))
        print(f"lstm_bwd H={Hn} T={T} B={Bn} ({tag}): kernel {k_ms:.3f} ms", flush=True)
        if took != (1 if r[0] else 0) or (Hn == 384) != (r[0] == 0):
            fail(f"lstm_bwd H={Hn}: route {r}, cluster launches {took}")
        err_max = max(err_max, float((got[0] - want[0]).abs().max()))
    b_ms, b_by = bound(ops, moved)
    return {"max_abs_err": err_max, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def check_spell_bwd(torch, rng, model):
    """K10 against spell_bwd_plain at the ASR step's shape (B = 32, L = 48, S
    = 64; tf 0.9, and 1.0 with a cotangent on the attention maps too) and
    the TAE step's (B = 64, S = 48, tf 0.9): the five streams by the
    float64-anchored rule, on the route by shape (the cluster route, from
    the gates K9 wrote) and on the one-row kernel; every route timed."""
    from ss_asr_tpu_torch.models import las
    from ss_asr_tpu_torch.ops.kernels import spell as kspell
    from ss_asr_tpu_torch.ops.kernels.decode import speller_weights
    from ss_asr_tpu_torch.vocab import VOCAB_SIZE

    enc_all, comp_all, lens_all = listener_memory(torch, rng, model, SPELL_SHAPES[1][0])
    cfg = model.cfg
    W = [w.detach() for w in speller_weights(model)]
    res = {"max_abs_err": 0.0}
    for (Bs, L, S), tfs in zip(SPELL_SHAPES[:2], ((0.9, 1.0), (0.9,))):
        enc_h, comp_h = enc_all[:Bs, :S].contiguous(), comp_all[:Bs, :S].contiguous()
        enc_lens = torch.clamp(lens_all[:Bs], max=S)
        by_shape = kspell.spell_route(Bs, cfg.decoder_state_size, cfg.enc_out_dim,
                                      cfg.mlp_out_size, S, VOCAB_SIZE)
        for tf in tfs:
            g = torch.Generator().manual_seed(SEED)
            tf_draws, gumbel = las.draw_scheduled_sampling(L, Bs, tf, model.cfg, g,
                                                           device=DEVICE)
            ids = torch.randint(0, VOCAB_SIZE, (L, Bs), generator=g).to(DEVICE)
            dlogits = torch.randn(L, Bs, VOCAB_SIZE, generator=g).to(DEVICE) / Bs
            daext = (torch.randn(L, Bs, S, generator=g).to(DEVICE) / Bs if tf == 1.0
                     else torch.zeros(L, Bs, S, device=DEVICE))
            with torch.no_grad():
                out = kspell.spell_fwd(model, enc_h, comp_h, enc_lens, tf_draws, gumbel,
                                       model.embed.weight[ids], with_gates=True)
                streams, gates = out[1:7], out[7:]
                args = (enc_h, comp_h, dlogits, daext, streams, W)
                want = kspell.spell_bwd_plain(*args)
                ref = kspell.spell_bwd_plain(enc_h.double(), comp_h.double(), dlogits.double(),
                                             daext.double(), tuple(s.double() for s in streams),
                                             [w.double() for w in W])
                for route in (by_shape, 0):
                    zero_launches()
                    got = kspell.spell_bwd(*args, gates if route else None, route=route)
                    torch.cuda.synchronize()
                    took = read_launches()
                    if took["spell_bwd"] != 1 or took["spell_bwd_cluster"] != int(route > 0):
                        fail(f"spell_bwd route {route}: launches {took}")
                    for name, a, b, r in zip(("dg1", "dg2", "de", "dqp", "demb"), got, want, ref):
                        anchored(torch, f"spell_bwd B={Bs} S={S} tf {tf} route {route} {name}",
                                 a, b, r)
                    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
                    res["max_abs_err"] = max(res["max_abs_err"], err)
                if tf != 0.9:
                    continue
                times = {r: cuda_ms(torch, lambda: kspell.spell_bwd(*args, gates if r else None,
                                                                    route=r))
                         for r in spell_routes(kspell, by_shape)}
                p_ms = cuda_ms(torch, lambda: kspell.spell_bwd_plain(*args, gates), reps=3)
            # the gates are inputs: the adjoint's products are one forward step's worth of
            # work (each product with a weight, transposed)
            b_ms, b_by = bound(Bs * L * speller_row_ops(W, S),
                               nbytes(enc_h, comp_h, dlogits, daext, *streams, *gates, *W, *got))
            print(f"spell_bwd B={Bs} L={L} S={S} tf {tf} ({int(tf_draws.sum())}/{L} teacher): "
                  + ", ".join(f"route {r} {ms:.3f} ms" for r, ms in times.items())
                  + f"; plain {p_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by}); by shape "
                  f"{times[by_shape] / L * 1e3:.1f} us/step", flush=True)
            if Bs == TRAIN_B:  # the train step's shape and rate
                res.update(ms=times[by_shape], plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                           bound_by=b_by)
    return {"spell_bwd": res}


FBANK_LOG_TOL = 1e-4  # K11 vs plain, log domain, energies within FBANK_FLOOR_DB of the frame's peak
FBANK_FLOOR_DB = 60.0
FBANK_LIN_TOL = 1e-5  # ... and every energy, linear domain, relative to the row's largest
POOL_TOL = 2e-2  # a gradient behind max-pools: relative L2 where a near-tied window flipped
TONE_FLOOR_DB = 30.0  # the log-domain floor on the pure-tone corpus, which has no noise floor
PEAK_F32 = 67e12  # H100 SXM, float32 outside the tensor cores, FLOP/s
PEAK_TF32 = 495e12  # H100 SXM, TF32 on the tensor cores, dense, FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM, device memory, bytes/s


def bound(ops: float, nbytes: float):
    """The least time the card could take, ms, and what binds it: float32
    operations at the FMA peak against bytes (inputs read once, outputs
    written once) at the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def speller_row_ops(ws, S, lm_ws=None) -> float:
    """Float32 operations of one attend-and-spell step of one row: the
    products with phi, the two LSTM cells and char_trans (``speller_weights``
    order), the attention's scores and context over S memory steps, and with
    ``lm_ws`` (``lm_operands`` order) the LM's two GRU cells and output."""
    ops = 2.0 * sum(ws[i].numel() for i in (0, 1, 2, 4, 5, 7))
    ops += 2.0 * S * (ws[0].shape[1] + ws[1].shape[0] - ws[2].shape[0])  # S * (M + F)
    if lm_ws is not None:
        ops += 2.0 * sum(w.numel() for w in lm_ws[1:] if w.dim() == 2)
    return ops


def cudnn_lstm_ms(torch, in_dim, H, T, Bn, backward: bool) -> float:
    """The library call beside K2 / K3: one bidirectional ``torch.nn.LSTM``
    layer (cuDNN, float32) at the same T, B and H, forward alone or forward
    + backward.  It runs the input projection too and does no packed masking;
    nothing on a main path calls it."""
    lstm = torch.nn.LSTM(in_dim, H, bidirectional=True).to(DEVICE)
    x = torch.randn(T, Bn, in_dim, device=DEVICE, requires_grad=backward)
    dy = torch.randn(T, Bn, 2 * H, device=DEVICE)

    def fwd():
        with torch.no_grad():
            lstm(x)

    def fwd_bwd():
        lstm(x)[0].backward(dy)

    return cuda_ms(torch, fwd_bwd if backward else fwd)


def fbank_errors(torch, got, want, floor_db=FBANK_FLOOR_DB):
    """K11's tolerance rule -> (log error, linear error).  The log magnifies
    summation-order differences without limit on digitally silent frames, so
    the log domain holds only energies within ``floor_db`` of their frame's
    peak (max abs difference of log-mels); every energy is held in the linear
    domain, |exp(got) - exp(want)| relative to the row's largest energy."""
    import math

    floor = want.amax(-1, keepdim=True) - floor_db * math.log(10) / 10
    above = want > floor
    log_err = float((got - want).abs()[above].max()) if bool(above.any()) else 0.0
    lin = (got.double().exp() - want.double().exp()).abs()
    lin_err = float((lin / want.double().exp().amax((-2, -1), keepdim=True)).max())
    return log_err, lin_err


def check_fbank(torch, rng, sigs, stream_sig):
    """K11 against fbank_plain on padded signals at the shapes of its callers:
    the training batch (TRAIN_B rows of up to FRAMES frames at SR, ragged),
    a preprocess batch (64 rows, sr 16000, a 20480-sample bucket grid, the
    last rows padding of 1 sample), the server batch (the N_REQUESTS signals
    on the half-second grid) and one streaming block.  Timed at the training
    batch beside the two-matmul pipeline and the bound."""
    import numpy as np

    from ss_asr_tpu_torch.ops import frontend as fe
    from ss_asr_tpu_torch.ops.kernels import frontend as kfe

    def tone_batch(sr, lens, n_buf):
        buf = np.zeros((len(lens), n_buf), np.float32)
        for i, k in enumerate(lens):
            t = np.arange(k) / sr
            buf[i, :k] = sum(0.2 * np.sin(2 * np.pi * f * t) for f in rng.uniform(100, 3000, 3))
            buf[i, :k] += 0.05 * rng.standard_normal(k)
        return buf

    hop = fe.frame_params(SR)[1]
    n_train = (rng.integers(TRAIN_MIN_FRAMES, FRAMES + 1, size=TRAIN_B) - 1) * hop + 1
    n_train[0] = (FRAMES - 1) * hop + 1
    n_pre = np.concatenate([rng.integers(16000, 4 * 16000, size=60), np.ones(4, np.int64)])
    step = SR // 2
    n_srv = np.array([len(s) for s in sigs])
    srv = np.zeros((len(sigs), -(-int(n_srv.max()) // step) * step), np.float32)
    for i, s in enumerate(sigs):
        srv[i, : len(s)] = s
    cases = [("train", SR, tone_batch(SR, n_train, int(n_train.max())), n_train),
             ("preprocess", 16000, tone_batch(16000, n_pre, -(-int(n_pre.max()) // 20480) * 20480),
              n_pre),
             ("server", SR, srv, n_srv)]
    res = {"max_abs_err": 0.0}
    for name, sr, buf, lens in cases:
        n_fft, hop = fe.frame_params(sr)
        y = torch.from_numpy(buf).to(DEVICE)
        yp = fe.reflect_padded(y, torch.from_numpy(lens).to(DEVICE), n_fft // 2)
        nf = int(fe.num_frames(buf.shape[1], n_fft, hop))
        wbasis, mel, wil = fe._projections(sr, fe.N_DIMS, fe.WIN_MS, fe.STRIDE_MS, yp.device)
        args = (yp, wbasis, mel, nf, n_fft, hop)
        with torch.inference_mode():
            got = kfe.fbank(*args, wil)
            torch.cuda.synchronize()
            want = kfe.fbank_plain(*args)
            # the valid frames hold the claim; the masked ones read another row's reflection
            valid = (torch.arange(nf, device=DEVICE)[None, :]
                     < fe.num_frames(torch.from_numpy(lens).to(DEVICE), n_fft, hop)[:, None])
            log_err, lin_err = fbank_errors(torch, got, want)
            k_ms = cuda_ms(torch, lambda: kfe.fbank(*args, wil), reps=9)
            p_ms = cuda_ms(torch, lambda: kfe.fbank_plain(*args), reps=9)
        n_bins, n_mels = mel.shape
        # the DFT product runs on the tensor cores (as 3xTF32: issued three times, counted
        # once); the power and the mel product are float32 FMAs
        dft = buf.shape[0] * nf * 2.0 * n_fft * 2 * n_bins
        rest = buf.shape[0] * nf * (3.0 * n_bins + 2 * n_bins * n_mels)
        moved = nbytes(yp, wbasis, mel, got)
        b_ms = max(dft / PEAK_TF32 * 1e3 + rest / PEAK_F32 * 1e3, moved / PEAK_BYTES * 1e3)
        b_by = "operations" if b_ms > moved / PEAK_BYTES * 1e3 else "bytes"
        f32_ms = bound(dft + rest, moved)[0]
        print(f"fbank {name} B={buf.shape[0]} nf={nf} sr={sr} ({int(valid.sum())} valid frames): "
              f"log max_abs_err {log_err:.3e} (energies within {FBANK_FLOOR_DB:.0f} dB of the "
              f"frame's peak), linear err {lin_err:.3e} of the row's largest; kernel {k_ms:.3f} ms "
              f"plain (two-matmul pipeline) {p_ms:.3f} ms bound {b_ms:.4f} ms ({b_by}; the DFT at "
              f"the TF32 tensor-core rate; {f32_ms:.4f} ms at the float32 FMA rate)", flush=True)
        if not (log_err <= FBANK_LOG_TOL and lin_err <= FBANK_LIN_TOL):
            fail(f"fbank {name}: log err {log_err} > {FBANK_LOG_TOL} or linear err {lin_err} > "
                 f"{FBANK_LIN_TOL}")
        res["max_abs_err"] = max(res["max_abs_err"], log_err)
        if name == "train":
            res.update(ms=k_ms, plain_ms=p_ms, library_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                       bound_f32_ms=f32_ms)

    # one block of the streaming frontend: a [1, block] chunk of the padded stream
    sfe = fe.StreamingFrontend(SR, device=DEVICE)
    n_fft, hop = sfe.n_fft, sfe.hop
    chunk = torch.from_numpy(stream_sig[: sfe.block].copy()).to(DEVICE)[None]
    nf = (sfe.block - n_fft) // hop + 1
    wbasis, mel, wil = fe._projections(SR, fe.N_DIMS, fe.WIN_MS, fe.STRIDE_MS, chunk.device)
    with torch.inference_mode():
        got = kfe.fbank(chunk, wbasis, mel, nf, n_fft, hop, wil)
        torch.cuda.synchronize()
        want = kfe.fbank_plain(chunk, wbasis, mel, nf, n_fft, hop)
        log_err, lin_err = fbank_errors(torch, got, want)
        k_ms = cuda_ms(torch, lambda: kfe.fbank(chunk, wbasis, mel, nf, n_fft, hop, wil), reps=9)
        p_ms = cuda_ms(torch, lambda: kfe.fbank_plain(chunk, wbasis, mel, nf, n_fft, hop), reps=9)
    print(f"fbank stream block {sfe.block} samples nf={nf}: log max_abs_err {log_err:.3e}, linear "
          f"err {lin_err:.3e}; kernel {k_ms:.3f} ms plain (two-matmul pipeline) {p_ms:.3f} ms",
          flush=True)
    if not (log_err <= FBANK_LOG_TOL and lin_err <= FBANK_LIN_TOL):
        fail(f"fbank stream block: log err {log_err}, linear err {lin_err}")
    res["max_abs_err"] = max(res["max_abs_err"], log_err)
    return {"fbank": res}


def train_config(config, split, n_epochs):
    """conf/default.yaml with the smoke's corpus (``split``: its train and
    eval indexes), batch and cadence."""
    c = copy.deepcopy(config)
    c["asr"].update(train_index=split[0], valid_index=split[1], train_batch_size=TRAIN_B,
                    valid_batch_size=TRAIN_B, n_epochs=n_epochs, logging_step=1,
                    save_step=1000, valid_step=1000, wer_step=1000)
    return c


def train_batch(torch, rng):
    """A seeded flagship batch: waveforms of 300-512 frames (10 ms hop at
    SR) on the card, and targets y [B, TRAIN_L + 1] (SOS, 12 to TRAIN_L - 1
    characters, EOS, SOS padding)."""
    import numpy as np

    from ss_asr_tpu_torch.ops.frontend import frame_params
    from ss_asr_tpu_torch.vocab import EOS_ID, VOCAB_SIZE

    hop = frame_params(SR)[1]
    frames = rng.integers(TRAIN_MIN_FRAMES, FRAMES + 1, size=TRAIN_B)
    frames[0] = FRAMES
    n = (frames - 1) * hop + 1  # the window is odd: a centred frontend gives 1 + (n - 1) // hop
    wave = np.zeros((TRAIN_B, int(n.max())), np.float32)
    for i, k in enumerate(n):
        t = np.arange(k) / SR
        wave[i, :k] = sum(0.2 * np.sin(2 * np.pi * f * t) for f in rng.uniform(100, 3000, 3))
        wave[i, :k] += 0.05 * rng.standard_normal(k)
    y = np.zeros((TRAIN_B, TRAIN_L + 1), np.int64)
    for i, k in enumerate(rng.integers(TRAIN_L // 4, TRAIN_L, size=TRAIN_B)):
        y[i, 1 : k + 1] = rng.integers(3, VOCAB_SIZE, size=k)
        y[i, k + 1] = EOS_ID
    return (torch.from_numpy(wave).to(DEVICE), torch.from_numpy(n).to(DEVICE),
            torch.from_numpy(y).to(DEVICE))


def trainer(config, tmp, name, tree, device):
    """An ASRTrainer on ``device`` whose checkpoint directory starts at ``tree``."""
    from ss_asr_tpu_torch.train.asr_trainer import ASRTrainer
    from ss_asr_tpu_torch.train.solver import make_paras
    from ss_asr_tpu_torch.utils.checkpoint import save_pytree

    paras = make_paras(name=name, logdir=os.path.join(tmp, "runs"),
                       ckpdir=os.path.join(tmp, "result"), seed=SEED, verbose=False)
    save_pytree(os.path.join(tmp, "result", name, "asr.npz"), tree)
    t = ASRTrainer(config, paras, device=device)
    t.set_model()
    return t


def profile_steps(torch, step, n):
    """torch.profiler over ``n`` steps: device time by kernel group and the
    device's idle share of the traced wall time.  Returns (wall ms a step,
    busy ms a step, idle share), or None when the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {"lstm_fwd (K2)": ("lstm_fwd_",), "lstm_bwd (K3)": ("lstm_bwd_",),
              "greedy_decode (K6 / K7)": ("greedy_decode_kernel", "greedy_cluster_kernel"),
              "beam_decode (K8)": ("beam_",),
              "spell_fwd (K9)": ("spell_fwd_",),
              "spell_bwd (K10, with its weight pack)": ("spell_bwd_", "pack_transpose"),
              "fbank (K11)": ("fbank_kernel",)}
    split, spans = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        low = e.name.lower()
        key = next((g for g, ks in groups.items() if any(k in low for k in ks)), None)
        if key is None:
            key = ("matmuls (einsums, projections)"
                   if any(s in low for s in ("gemm", "gemv", "cutlass", "sm90", "splitk"))
                   else "other (elementwise, reductions, optimizer, copies)")
        split[key] = split.get(key, 0.0) + (e.time_range.end - e.time_range.start)
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    if not spans:
        print("profile: torch.profiler saw no device time; the CUDA-event step time stands alone",
              flush=True)
        return None
    print(f"profile of {n} steps: wall {wall_us / 1e3 / n:.3f} ms/step, device busy "
          f"{busy / 1e3 / n:.3f} ms/step, idle share {1 - busy / wall_us:.3f}", flush=True)
    for key, us in sorted(split.items(), key=lambda kv: -kv[1]):
        print(f"profile: {key}: {us / 1e3 / n:.3f} ms/step ({us / busy:.3f} of busy)", flush=True)
    return wall_us / 1e3 / n, busy / 1e3 / n, 1 - busy / wall_us


def check_train_step(torch, rng, config, asr_tree, tmp):
    """The flagship train step: the card's loss and gradients, and the CPU's
    (plain versions), against a float64 run of the plain versions on one
    batch with the same draws (the card's error at most ANCHOR_RATIO times
    the CPU's, or below STEP_FLOOR); every trained parameter, the
    listener's included, with a gradient.  Then TRAIN_STEPS steps (frontend from the
    waveform + forward + backward + clip + Adadelta) timed with CUDA
    events, the kernels' launch counters zeroed just before them and read
    just after; then a profile.  Returns those launches."""
    from ss_asr_tpu_torch.models import las
    from ss_asr_tpu_torch.ops.frontend import log_mel_fbank_batch
    from ss_asr_tpu_torch.train import losses

    wave, n, y = train_batch(torch, rng)
    with torch.no_grad():
        x, x_lens = log_mel_fbank_batch(wave, n, SR)
    card, cpu, ref = (trainer(config, tmp, f"step_{name}", asr_tree, dev)
                      for name, dev in (("card", DEVICE), ("cpu", "cpu"), ("f64", "cpu")))
    loss = card.step(x, x_lens, y)[0]
    t0 = time.perf_counter()
    want = cpu.step(x.cpu(), x_lens.cpu(), y.cpu())[0]
    print(f"train step on the CPU (plain versions): {time.perf_counter() - t0:.1f} s", flush=True)
    # the anchor: the same step's loss and gradients in float64 on the CPU
    # (the same draws: each trainer's generator starts from the same seed)
    L = y.shape[1] - 1
    tf_draws, gumbel = las.draw_scheduled_sampling(L, TRAIN_B, ref.cfg.tf_rate, ref.cfg,
                                                   ref.generator, device="cpu")
    m64, y_cpu = ref.model.double(), y.cpu()
    logits = las.asr_forward(m64, x.cpu().double(), x_lens.cpu(), L, teacher=y_cpu,
                             tf_draws=tf_draws, gumbel=gumbel)[1]
    loss64 = losses.masked_ce_per_utt(logits, y_cpu[:, 1:], y_cpu)
    loss64.backward()
    worst, missing, bad = (0.0, 0.0, ""), [], []
    cpu_params, ref_params = dict(cpu.model.named_parameters()), dict(m64.named_parameters())
    trained = [(n, p) for n, p in card.model.named_parameters() if p.requires_grad]
    pairs = [("loss", loss.cpu(), want, loss64.detach())]
    for name, p in trained:
        if p.grad is None or float(p.grad.abs().sum()) == 0.0:
            missing.append(name)
            continue
        pairs.append((name, p.grad.cpu(), cpu_params[name].grad, ref_params[name].grad))
    for name, got, plain, r in pairs:
        k, c = rel_l2(torch, got, r), rel_l2(torch, plain, r)
        worst = max(worst, (k, c, name))
        if not k <= max(ANCHOR_RATIO * c, STEP_FLOOR):
            bad.append(f"{name} (card {k:.3e}, CPU {c:.3e})")
    print(f"train step B={TRAIN_B} T={x.shape[1]} L={TRAIN_L}: loss card {float(loss):.6f} CPU "
          f"{float(want):.6f} float64 {float(loss64.detach()):.6f}; the loss and the "
          f"{len(trained)} trained gradients against float64: worst card rel L2 {worst[0]:.3e} "
          f"(CPU float32 {worst[1]:.3e}, {worst[2]})", flush=True)
    if missing:
        fail(f"train step: no gradient on the card for {missing}")
    if bad:
        fail(f"train step: card error against float64 above {ANCHOR_RATIO} x the CPU float32's "
             f"and {STEP_FLOOR}: {bad}")

    def step():
        with torch.no_grad():
            fb, fl = log_mel_fbank_batch(wave, n, SR)
        return card.step(fb, fl, y)

    step()  # warm-up
    zero_launches()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step()[0])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    launches = read_launches()
    ms = statistics.median(times)
    print(f"train step B={TRAIN_B} T={x.shape[1]} L={TRAIN_L} (frontend + forward + backward + "
          f"clip + Adadelta): median of {TRAIN_STEPS} {ms:.3f} ms, {TRAIN_B / ms * 1e3:.1f} utt/s "
          f"(min {min(times):.3f}, max {max(times):.3f}); losses {float(losses[0]):.4f} -> "
          f"{float(losses[-1]):.4f}; launches {launches}", flush=True)
    for name in ("fbank", "lstm_fwd", "lstm_bwd", "spell_fwd", "spell_bwd"):
        if launches[name] < 1:
            fail(f"train step: launched {name} {launches[name]} times")
    require_cluster_route("train step", launches)
    if not all(bool(torch.isfinite(v)) for v in losses):
        fail("train step: a non-finite loss")
    profile_steps(torch, step, 3)
    return launches


def write_corpus(rng, tmp, n_utts):
    """A seeded flagship-sized corpus: 40-mel fbanks of 300-512 frames,
    texts of 12-46 characters (at most 48 ids with SOS and EOS), and its index."""
    import numpy as np

    from ss_asr_tpu_torch.vocab import ALL_CHARS, EOS_TKN, SOS_TKN

    rows = []
    for i in range(n_utts):
        T = int(rng.integers(TRAIN_MIN_FRAMES, FRAMES + 1))
        path = os.path.join(tmp, f"u{i}.npy")
        np.save(path, rng.standard_normal((T, 40)).astype(np.float32))
        text = "".join(rng.choice(list(ALL_CHARS), size=int(rng.integers(TRAIN_L // 4, TRAIN_L - 1))))
        rows.append((SOS_TKN + text + EOS_TKN, path, len(text) + 2, T, "na", f"u{i}.wav"))
    idx = os.path.join(tmp, "index.tsv")
    with open(idx, "w", encoding="utf-8") as f:
        for r in sorted(rows, key=lambda r: r[3]):
            f.write("\t".join(str(a) for a in r) + "\n")
    return idx


def held_out_split(idx):
    """``make_split`` of an index (90 / 10, seeded) -> (train.tsv, eval.tsv)
    beside it, each with at least one row."""
    from ss_asr_tpu_torch.data.index import load_index, make_split

    make_split(idx, seed=SEED)
    split = tuple(os.path.join(os.path.dirname(idx), f"{n}.tsv") for n in ("train", "eval"))
    sizes = [len(load_index(p)) for p in split]
    if min(sizes) < 1:
        fail(f"make_split of {idx}: {sizes} rows")
    print(f"make_split of {os.path.basename(os.path.dirname(idx))}/{os.path.basename(idx)}: "
          f"{sizes[0]} rows to train on, {sizes[1]} held out for validation", flush=True)
    return split


def check_cli_train(rng, config, tmp):
    """``python -m ss_asr_tpu_torch.cli.train ASRTrainer`` as a subprocess on
    one repeated flagship batch (the train side of a held-out split holds
    one batch of TRAIN_B and a part): CLI_STEPS steps whose loss must fall,
    the checkpoints and the tracker written; then a second invocation
    resumes at the saved step."""
    import numpy as np
    import yaml

    from ss_asr_tpu_torch.data.index import load_index

    split = held_out_split(write_corpus(rng, tmp, CLI_UTTS))
    if not TRAIN_B <= len(load_index(split[0])) < 2 * TRAIN_B:
        fail(f"cli.train: the train split does not hold exactly one batch of {TRAIN_B}")
    log = os.path.join(tmp, "cli_runs", "smoke", "asr", "metrics.jsonl")
    ck = os.path.join(tmp, "cli_result", "smoke")

    def run(n_epochs):
        path = os.path.join(tmp, f"cli_{n_epochs}_epochs.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(train_config(config, split, n_epochs), f)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ss_asr_tpu_torch.cli.train", "ASRTrainer", "smoke", path,
             os.path.join(tmp, "cli_runs"), os.path.join(tmp, "cli_result"), "--seed",
             str(SEED), "--verbose", "0", "--device", DEVICE],
            cwd=HERE, env={**os.environ, "PYTHONPATH": HERE}, capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            fail(f"cli.train exited {proc.returncode}: {proc.stderr[-3000:]}")
        with open(log) as f:
            recs = [json.loads(line) for line in f]
        with open(os.path.join(ck, "tracker.json")) as f:
            step = json.load(f)["asr"]["step"]
        return time.perf_counter() - t0, recs, step

    secs, recs, step = run(CLI_STEPS)
    losses = [r["value"] for r in recs if r["key"] == "asr_train_loss"]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"cli.train ASRTrainer: {len(losses)} steps of B={TRAIN_B} in {secs:.1f} s (process "
          f"included); loss {losses[0]:.4f} -> {losses[-1]:.4f} (first 5 mean {first:.4f}, last 5 "
          f"{last:.4f}); tracker step {step}", flush=True)
    if not (len(losses) == CLI_STEPS and step == CLI_STEPS and last < first):
        fail(f"cli.train: {len(losses)} losses, tracker step {step}, loss {first} -> {last}")
    for name in ("asr.npz", "asr_opt.npz", "tracker.json"):
        if not os.path.isfile(os.path.join(ck, name)):
            fail(f"cli.train wrote no {name}")
    secs, recs, step = run(2)
    resumed = [r for r in recs if r["key"] == "asr_train_loss"][CLI_STEPS:]
    print(f"cli.train resumed: steps {[r['step'] for r in resumed]} in {secs:.1f} s, loss "
          f"{resumed[0]['value']:.4f}; tracker step {step}", flush=True)
    if not ([r["step"] for r in resumed] == [CLI_STEPS, CLI_STEPS + 1]
            and step == CLI_STEPS + 2 and resumed[0]["value"] < first):
        fail(f"cli.train did not resume at step {CLI_STEPS}: {resumed}, tracker step {step}")


def check_preprocess(torch, tmp):
    """``cli.mkdata`` then ``cli.preprocess generic`` as subprocesses on
    PRE_UTTS tone utterances resampled to 16 kHz: the frontend kernel must
    have launched there, ``index.tsv`` must list the corpus in frame order,
    and every fbank must equal the plain version of the frontend, computed
    here on the same samples, by K11's tolerance rule.  The corpus is pure
    tones with no noise floor: a band 30-60 dB under its frame's peak is a
    difference of large float32 products, so here the log domain holds the
    energies within TONE_FLOOR_DB of the peak and the linear domain the
    rest.  Returns (index path, the subprocess's K11 launches)."""
    import re

    import numpy as np

    from ss_asr_tpu_torch.data.audio import load_wav
    from ss_asr_tpu_torch.data.index import load_index
    from ss_asr_tpu_torch.ops import frontend as fe
    from ss_asr_tpu_torch.ops.kernels import frontend as kfe

    root = os.path.join(tmp, "corpus")
    env = {**os.environ, "PYTHONPATH": HERE}

    def run(*argv):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *argv], cwd=HERE, env=env,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"{argv[0]} exited {proc.returncode}: {proc.stderr[-3000:]}")
        return time.perf_counter() - t0, proc.stdout

    run("ss_asr_tpu_torch.cli.mkdata", root, "--n", str(PRE_UTTS), "--seed", str(SEED))
    secs, out = run("ss_asr_tpu_torch.cli.preprocess", "generic", os.path.join(root, "processed"),
                    os.path.join(root, "wav"), os.path.join(root, "txt"), "--sr", str(PRE_SR),
                    "--device", DEVICE)
    m = re.search(r"(\d+) kernel launches", out)
    launched = int(m.group(1)) if m else 0
    idx = os.path.join(root, "processed", "index.tsv")
    rows = load_index(idx)
    frames = [r["unpadded_num_frames"] for r in rows]
    if not (len(rows) == PRE_UTTS and frames == sorted(frames) and launched >= 1
            and {os.path.basename(r["wav_fname"]) for r in rows}
            == set(os.listdir(os.path.join(root, "wav")))):
        fail(f"cli.preprocess: {len(rows)} index rows for {PRE_UTTS} utterances, frame counts "
             f"sorted {frames == sorted(frames)}, K11 launches {launched}")
    n_fft, hop = fe.frame_params(PRE_SR)
    wbasis, mel, _ = fe._projections(PRE_SR, fe.N_DIMS, fe.WIN_MS, fe.STRIDE_MS,
                                     torch.device(DEVICE))
    worst = (0.0, 0.0, 0.0)
    for r in rows:
        y = torch.from_numpy(load_wav(r["wav_fname"], target_sr=PRE_SR)[1]).to(DEVICE)[None]
        nf = int(fe.num_frames(y.shape[1], n_fft, hop))
        want = kfe.fbank_plain(fe.reflect_padded(y, None, n_fft // 2), wbasis, mel, nf, n_fft,
                               hop)[0]
        got = torch.from_numpy(np.load(r["path_to_fbank"])).to(DEVICE)
        if got.shape != want.shape or got.shape[0] != r["unpadded_num_frames"]:
            fail(f"cli.preprocess: {r['path_to_fbank']} has shape {tuple(got.shape)}, the plain "
                 f"frontend gives {tuple(want.shape)}, the index says {r['unpadded_num_frames']}")
        errs = (*fbank_errors(torch, got, want, TONE_FLOOR_DB),
                fbank_errors(torch, got, want)[0])
        worst = tuple(max(a, b) for a, b in zip(worst, errs))
    print(f"cli.preprocess generic: {PRE_UTTS} utterances at sr {PRE_SR} in {secs:.1f} s "
          f"(process included), {PRE_UTTS / secs:.2f} utt/s; K11 launches {launched}; every fbank "
          f"against the plain frontend: log max_abs_err {worst[0]:.3e} within "
          f"{TONE_FLOOR_DB:.0f} dB of the frame's peak ({worst[2]:.3e} within "
          f"{FBANK_FLOOR_DB:.0f} dB, not held: pure tones), linear err {worst[1]:.3e}",
          flush=True)
    if not (worst[0] <= FBANK_LOG_TOL and worst[1] <= FBANK_LIN_TOL):
        fail(f"cli.preprocess: fbanks differ from the plain frontend by {worst[:2]}")
    return idx, launched


def aux_trainer(cls, config, tmp, name, trees, device):
    """A TAE / SAE / ADV trainer on ``device`` whose checkpoint directory
    starts at ``trees`` ({file stem: tree})."""
    from ss_asr_tpu_torch.train.solver import make_paras
    from ss_asr_tpu_torch.utils.checkpoint import save_pytree

    paras = make_paras(name=name, logdir=os.path.join(tmp, "runs"),
                       ckpdir=os.path.join(tmp, "result"), seed=SEED, verbose=False)
    for stem, tree in trees.items():
        save_pytree(os.path.join(tmp, "result", name, f"{stem}.npz"), tree)
    t = cls(config, paras, device=device)
    t.set_model()
    return t


def anchored_losses(torch, tag, trainers, run, pooled=()):
    """One loss and its gradients on the card, on the CPU (plain versions)
    and in float64 on the CPU, from ``run(trainer, device) -> loss``: the
    card's relative L2 error against float64 of the loss and of every
    gradient at most ANCHOR_RATIO times the CPU float32 run's own, or below
    STEP_FLOOR; the same parameters carry a gradient in all three.

    ``pooled``: name prefixes of the parameters whose gradient passes
    through max-pools.  A max-pool's winner is a discrete choice: where two
    candidates of a window lie within float32 rounding of each other, the
    card, the CPU and float64 may each route that window's whole gradient
    to another position, and behind a global pool few routes carry the
    gradient (measured: one flipped window of 338,000 moves these gradients
    by 3e-4 to 4e-3, on the card in one run and on the CPU in another).
    Such a gradient may miss the anchored bound if it stays within
    POOL_TOL; the print counts those.  Returns their names."""
    from ss_asr_tpu_torch.train.solver import joint_named_parameters

    res = []
    for t, dev in zip(trainers, (DEVICE, "cpu", "cpu")):
        for m in t.models.values():
            m.zero_grad(set_to_none=True)
        loss = run(t, dev)
        loss.backward()
        res.append((loss.detach().cpu(), {n: p.grad.cpu() for n, p in
                                          joint_named_parameters(t.models) if p.grad is not None}))
    (loss, grads), (loss_c, grads_c), (loss_r, grads_r) = res
    if not (set(grads) == set(grads_c) == set(grads_r)) or any(
            float(g.abs().sum()) == 0.0 for g in grads.values()):
        fail(f"{tag}: the card's gradients {sorted(grads)} are not the CPU's {sorted(grads_c)}, "
             "or one is zero")
    worst, bad, flipped = (0.0, 0.0, ""), [], []
    for name, got, plain, r in [("loss", loss, loss_c, loss_r)] + [
            (n, grads[n], grads_c[n], grads_r[n]) for n in sorted(grads)]:
        k, c = rel_l2(torch, got, r), rel_l2(torch, plain, r)
        worst = max(worst, (k, c, name))
        if k <= max(ANCHOR_RATIO * c, STEP_FLOOR):
            continue
        if name.startswith(tuple(pooled)) and pooled and k <= POOL_TOL:
            flipped.append(name)
        else:
            bad.append(f"{name} (card {k:.3e}, CPU {c:.3e})")
    print(f"{tag}: loss card {float(loss):.6f} CPU {float(loss_c):.6f} float64 "
          f"{float(loss_r):.6f}; the loss and {len(grads)} gradients against float64: worst card "
          f"rel L2 {worst[0]:.3e} (CPU float32 {worst[1]:.3e}, {worst[2]})"
          + (f"; {len(flipped)} gradients behind max-pools above the anchored bound and within "
             f"{POOL_TOL}: {flipped}" if flipped else ""), flush=True)
    if bad:
        fail(f"{tag}: card error against float64 above {ANCHOR_RATIO} x the CPU float32's and "
             f"{STEP_FLOOR}: {bad}")
    return flipped


def relu_flip_sweep(torch, tag, trainers, draw, seeds):
    """The ADV D-step's anchored comparison over the seeded draws of
    ``seeds`` (``draw(rng) -> (x, x_lens, y, y_lens)`` on the card), each
    draw with its witnesses: the listener's and the text encoder's outputs
    (the discriminator's inputs) against float64 on the card and the CPU,
    and the discriminator's ReLU decisions that the card and the CPU take
    otherwise than float64 (a pre-activation within float32 rounding of 0).

    A ReLU's decision is a discrete choice, as a max-pool's winner is: one
    flipped unit at one of the ~3,600 positions adds or drops that unit's
    whole term of the weight gradients (of the order 1 / (positions x
    sqrt(units)) of their norm).  Where a gradient misses the anchored rule,
    it is compared again with a float64 run whose ReLUs take the card's
    decisions; it passes only if the card took a decision float64 did not
    and it meets the rule against that run.  Every draw's readings are
    printed.  Returns the names that passed so, over all draws."""
    import numpy as np

    from ss_asr_tpu_torch.train.solver import joint_named_parameters

    def relus(t):
        return [m for m in t.models["disc"].core if isinstance(m, torch.nn.ReLU)]

    def run(t, dev, x, xl, y, yl, masks=None):
        """Loss, grads, the outputs and each ReLU call's pre-activation; with
        ``masks`` the ReLUs output pre-activation x mask (forced decisions)."""
        pre, forced = [], list(masks) if masks is not None else None

        def hook(_m, inp, out):
            pre.append(inp[0].detach().cpu().double())
            if forced is not None:
                return inp[0] * forced.pop(0).to(inp[0])
            return None

        handles = [m.register_forward_hook(hook) for m in relus(t)]
        try:
            for m in t.models.values():
                m.zero_grad(set_to_none=True)
            dt = next(t.models["disc"].parameters()).dtype
            rl, fl, real, fake = t.d_losses(x.to(dev).to(dt), xl.to(dev), y.to(dev), yl.to(dev),
                                            t.label_smoothing)
            (rl + fl).backward()
        finally:
            for h in handles:
                h.remove()
        grads = {n: p.grad.cpu() for n, p in joint_named_parameters(t.models) if p.grad is not None}
        return float((rl + fl).detach()), grads, real.detach().cpu(), fake.detach().cpu(), pre

    flipped = set()
    for seed in seeds:
        x, xl, y, yl = draw(np.random.default_rng(seed))
        card, cpu, ref = (run(t, dev, x, xl, y, yl)
                          for t, dev in zip(trainers, (DEVICE, "cpu", "cpu")))
        unlike = [(a > 0) != (r > 0) for a, r in zip(card[4], ref[4])]
        flips = [int(d.sum()) for d in unlike]
        cflips = [int(((a > 0) != (r > 0)).sum()) for a, r in zip(cpu[4], ref[4])]
        near = max((float(r[d].abs().max()) for r, d in zip(ref[4], unlike) if d.any()),
                   default=0.0)
        errs = {n: (rel_l2(torch, card[1][n], ref[1][n]), rel_l2(torch, cpu[1][n], ref[1][n]))
                for n in ref[1]}
        over = [n for n, (k, c) in errs.items() if k > max(ANCHOR_RATIO * c, STEP_FLOOR)]
        worst = max(errs.items(), key=lambda kv: kv[1][0])
        line = (f"{tag} seed {seed}: loss card {card[0]:.6f} float64 {ref[0]:.6f}; listener output "
                f"rel L2 card {rel_l2(torch, card[3], ref[3]):.3e} CPU "
                f"{rel_l2(torch, cpu[3], ref[3]):.3e}, text encoder card "
                f"{rel_l2(torch, card[2], ref[2]):.3e} CPU {rel_l2(torch, cpu[2], ref[2]):.3e}; "
                f"ReLU decisions unlike float64 (layer 1, 2 on text, then speech): card {flips} "
                f"CPU {cflips}" + (f" (largest float64 |pre-activation| among the card's "
                                   f"{near:.3e})" if sum(flips) else "")
                + f"; worst gradient card {worst[1][0]:.3e} CPU {worst[1][1]:.3e} ({worst[0]})")
        bad = []
        if over:
            # float64 again, its ReLUs taking the card's decisions
            masks = [(a > 0).double() for a in card[4]]
            _, g_al, _, _, _ = run(trainers[2], "cpu", x, xl, y, yl, masks=masks)
            al = {n: rel_l2(torch, card[1][n], g_al[n]) for n in over}
            line += (f"; {len(over)} above the rule: {[f'{n} {errs[n][0]:.3e}' for n in over]}, "
                     f"against float64 with the card's ReLU decisions worst {max(al.values()):.3e}")
            bad = [n for n in over if not (sum(flips) and al[n] <= max(ANCHOR_RATIO * errs[n][1],
                                                                      STEP_FLOOR))]
        print(line, flush=True)
        if bad:
            fail(f"{tag} seed {seed}: card error against float64 above {ANCHOR_RATIO} x the CPU "
                 f"float32's and {STEP_FLOOR}, not explained by a flipped ReLU: {bad}")
        flipped.update(over)
    return flipped


def timed_steps(torch, tag, trainer, optims, step, batch, need):
    """AUX_STEPS updates of ``trainer`` on the card, timed with CUDA events,
    the launch counters zeroed just before and read just after: every
    kernel of ``need`` must launch, every parameter outside the optimizers'
    masks must stay bit-unchanged and every one inside must move.  Then a
    torch.profiler split of 2 more updates."""
    from ss_asr_tpu_torch.train.solver import joint_named_parameters

    step()  # warm-up
    before = {n: p.detach().clone() for n, p in joint_named_parameters(trainer.models)}
    zero_launches()
    times = []
    for _ in range(AUX_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    launches = read_launches()
    ms = statistics.median(times)
    trained = set().union(*(o.mask for o in optims))
    after = dict(joint_named_parameters(trainer.models))
    moved = {n for n in before if not torch.equal(before[n], after[n])}
    print(f"{tag} B={batch}: median of {AUX_STEPS} {ms:.3f} ms, {batch / ms * 1e3:.1f} utt/s (min "
          f"{min(times):.3f}, max {max(times):.3f}); {len(moved)} of {len(before)} parameters moved, "
          f"the other {len(before) - len(moved)} bit-unchanged; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if moved != trained:
        fail(f"{tag}: moved {sorted(moved ^ trained)} against the optimizer masks")
    for name in need:
        if launches[name] < 1:
            fail(f"{tag}: launched {name} {launches[name]} times")
    require_cluster_route(tag, launches)
    profile_steps(torch, step, 2)
    return launches


def text_batch(torch, rng, batch, drop_rate):
    """Seeded target ids [batch, TRAIN_L] (SOS, 12 to TRAIN_L - 2 characters,
    EOS, SOS padding), a noised copy (each character dropped with
    ``drop_rate``) and the dataset's lengths of both (non-pad count + 1)."""
    import numpy as np

    from ss_asr_tpu_torch.vocab import EOS_ID, VOCAB_SIZE

    y = np.zeros((batch, TRAIN_L), np.int64)
    yn = np.zeros((batch, TRAIN_L), np.int64)
    for i, k in enumerate(rng.integers(TRAIN_L // 4, TRAIN_L - 1, size=batch)):
        ids = rng.integers(3, VOCAB_SIZE, size=k)
        kept = ids[rng.random(k) > drop_rate]
        y[i, 1 : k + 1], y[i, k + 1] = ids, EOS_ID
        yn[i, 1 : len(kept) + 1], yn[i, len(kept) + 1] = kept, EOS_ID
    return tuple(torch.from_numpy(a) for a in
                 (y, (y != 0).sum(-1) + 1, yn, (yn != 0).sum(-1) + 1))


def check_aux_trainers(torch, rng, config, asr_tree, tmp):
    """The TAE, SAE and ADV train steps at the full width of
    conf/default.yaml (TAE B = 64; SAE and ADV B = 32, T = 512 frames): each
    loss and every gradient on the card against the CPU's plain versions by
    the float64-anchored rule, then timed updates with their kernel launches
    and the frozen subtrees checked.  Returns {path: launches}."""
    from ss_asr_tpu_torch import convert
    from ss_asr_tpu_torch.models import discriminator as disc_mod
    from ss_asr_tpu_torch.models import las
    from ss_asr_tpu_torch.models import speech_autoencoder as sae_mod
    from ss_asr_tpu_torch.models import text_autoencoder as tae_mod
    from ss_asr_tpu_torch.ops.frontend import log_mel_fbank_batch
    from ss_asr_tpu_torch.train.adv_trainer import ADVTrainer
    from ss_asr_tpu_torch.train.sae_trainer import SAETrainer
    from ss_asr_tpu_torch.train.tae_trainer import TAETrainer

    asr_cfg = las.ASRConfig.from_dict(config["asr"]["mdl"])
    tae_tree = convert.init_tae_numpy(SEED + 3, tae_mod.TAEConfig.from_dict(config["tae"]["mdl"]))
    sae_cfg = sae_mod.SAEConfig.from_dict({**config["sae"]["mdl"],
                                           "listener_out_dim": asr_cfg.enc_out_dim})
    sae_params, sae_bn = convert.init_sae_numpy(SEED + 4, sae_cfg)
    disc_tree = convert.init_disc_numpy(SEED + 5, disc_mod.DiscriminatorConfig.from_dict(
        {**config["adv"]["mdl"], "in_dim": asr_cfg.enc_out_dim}))
    wave, n, _ = train_batch(torch, rng)
    with torch.no_grad():
        x, x_lens = log_mel_fbank_batch(wave, n, SR)
    launches = {}

    def three(cls, name, trees):
        ts = [aux_trainer(cls, config, tmp, f"{name}_{tag}", trees, dev)
              for tag, dev in (("card", DEVICE), ("cpu", "cpu"), ("f64", "cpu"))]
        for m in ts[2].models.values():
            m.double()
        return ts

    # TAE: the text encoder (K2 / K3) and the ASR's speller over its memory (K9 / K10)
    tae_b = config["tae"]["train_batch_size"]
    y, _, yn, nl = text_batch(torch, rng, tae_b, config["tae"]["drop_rate"])
    ts = three(TAETrainer, "tae", {"asr": asr_tree, "tae": tae_tree})
    anchored_losses(torch, f"TAE step B={tae_b} L={TRAIN_L} S={yn.shape[1]}", ts,
                    lambda t, dev: t.loss_of(y.to(dev), yn.to(dev), nl.to(dev))[0])
    card = ts[0]
    args = (y.to(DEVICE), yn.to(DEVICE), nl.to(DEVICE))
    launches["tae step"] = timed_steps(
        torch, "TAE step (forward + backward + clip + Adam)", card, [card.optim],
        lambda: card.step(*args), tae_b, ("lstm_fwd", "lstm_bwd", "spell_fwd", "spell_bwd"))

    # SAE: the listener (K2 / K3), the conv encoder and the MLP decoder
    ts = three(SAETrainer, "sae", {"asr": asr_tree, "sae": {"params": sae_params,
                                                            "bn_state": sae_bn}})
    anchored_losses(torch, f"SAE step B={TRAIN_B} T={x.shape[1]}", ts,
                    lambda t, dev: t.recon_loss(
                        x.to(dev).to(next(t.models["sae"].parameters()).dtype), x_lens.to(dev),
                        True)[0], pooled=("sae.encoder.",))
    card = ts[0]
    launches["sae step"] = timed_steps(
        torch, "SAE step (forward + backward + clip + Adam)", card, [card.optim],
        lambda: card.step(x, x_lens), TRAIN_B, ("lstm_fwd", "lstm_bwd"))

    # ADV: the D-step, then the G-step, two optimizers over one parameter set
    y, y_lens, _, _ = text_batch(torch, rng, TRAIN_B, 0.0)
    ts = three(ADVTrainer, "adv", {"asr": asr_tree, "tae": tae_tree, "adv": disc_tree})

    def cast(t, dev):
        return x.to(dev).to(next(t.models["disc"].parameters()).dtype)

    anchored_losses(torch, f"ADV D-step B={TRAIN_B} T={x.shape[1]} S={y.shape[1]}", ts,
                    lambda t, dev: sum(t.d_losses(cast(t, dev), x_lens.to(dev), y.to(dev),
                                                  y_lens.to(dev), t.label_smoothing)[:2]))
    anchored_losses(torch, f"ADV G-step B={TRAIN_B} T={x.shape[1]}", ts,
                    lambda t, dev: t.g_loss(cast(t, dev), x_lens.to(dev)))

    def adv_draw(r):
        wave, n, _ = train_batch(torch, r)
        with torch.no_grad():
            xs, xls = log_mel_fbank_batch(wave, n, SR)
        return (xs, xls) + text_batch(torch, r, TRAIN_B, 0.0)[:2]

    relu_flip_sweep(torch, f"ADV D-step sweep B={TRAIN_B}", ts, adv_draw, ADV_SEEDS)
    card = ts[0]
    yd, yld = y.to(DEVICE), y_lens.to(DEVICE)

    def d_and_g():
        card.d_step(x, x_lens, yd, yld)
        card.g_step(x, x_lens)

    launches["adv steps"] = timed_steps(
        torch, "ADV D-step + G-step (each forward + backward + clip + Adadelta)", card,
        [card.D_optim, card.G_optim], d_and_g, TRAIN_B, ("lstm_fwd", "lstm_bwd"))
    return launches


def check_cli_seed(config, idx, tmp):
    """``cli.train Seed`` as a subprocess on the preprocessed corpus, one
    super-iteration of TAE -> ADV -> SAE at the full width: the stages'
    files and the three ASR relays written, every logged loss finite; then
    ``cli.train ASRTrainer`` from the last relay for a few epochs, whose
    last epoch's mean loss must be below its first's (the same batches)."""
    import numpy as np
    import yaml

    train, held = held_out_split(idx)
    c = copy.deepcopy(config)
    for key, epochs in (("tae", SEED_EPOCHS["tae"]), ("adv", SEED_EPOCHS["adv"]),
                        ("sae", SEED_EPOCHS["sae"]), ("asr", SEED_EPOCHS["asr"])):
        c[key].update(train_index=train, valid_index=held, n_epochs=epochs, logging_step=1,
                      save_step=1000, valid_step=4)
    c["adv"]["eval_index"] = held
    c["asr"].update(train_batch_size=TRAIN_B, valid_batch_size=TRAIN_B, wer_step=1000)
    c["seed_train"] = {"super_its": 1}
    path = os.path.join(tmp, "seed.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(c, f)
    ck = os.path.join(tmp, "seed_result", "seed")

    def run(kind):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ss_asr_tpu_torch.cli.train", kind, "seed", path,
             os.path.join(tmp, "seed_runs"), os.path.join(tmp, "seed_result"), "--seed", str(SEED),
             "--verbose", "1", "--device", DEVICE],
            cwd=HERE, env={**os.environ, "PYTHONPATH": HERE}, capture_output=True, text=True,
            timeout=900)
        if proc.returncode != 0:
            fail(f"cli.train {kind} exited {proc.returncode}: {proc.stderr[-3000:]}")
        return time.perf_counter() - t0, proc.stdout

    def scalars(module, key):
        with open(os.path.join(tmp, "seed_runs", "seed", module, "metrics.jsonl")) as f:
            return [r["value"] for r in map(json.loads, f) if r["key"] == f"{module}_{key}"]

    secs, _ = run("Seed")
    files = ("asr_1.npz", "asr_2.npz", "asr_3.npz", "tae.npz", "tae_opt.npz", "adv.npz",
             "adv_G_opt.npz", "adv_D_opt.npz", "sae.npz", "sae_opt.npz", "tracker.json")
    missing = [name for name in files if not os.path.isfile(os.path.join(ck, name))]
    tae, sae = scalars("tae", "train_loss"), scalars("sae", "train_loss")
    gen = scalars("adv", "gen_loss_train")
    print(f"cli.train Seed (TAE {SEED_EPOCHS['tae']}, ADV {SEED_EPOCHS['adv']}, SAE "
          f"{SEED_EPOCHS['sae']} epochs on the train side of a held-out split of {PRE_UTTS} "
          f"utterances) in {secs:.1f} s (process "
          f"included): TAE loss {tae[0]:.4f} -> {tae[-1]:.4f} over {len(tae)} steps, ADV generator "
          f"loss {gen[0]:.4f} -> {gen[-1]:.4f} over {len(gen)}, SAE loss {sae[0]:.4f} -> "
          f"{sae[-1]:.4f} over {len(sae)}; relays asr_1, asr_2, asr_3 written", flush=True)
    if missing or not all(len(v) > 0 and np.isfinite(v).all() for v in (tae, sae, gen)):
        fail(f"cli.train Seed: missing {missing}, or a stage logged no loss or a non-finite one")
    shutil.copyfile(os.path.join(ck, "asr_3.npz"), os.path.join(ck, "asr.npz"))
    secs, out = run("ASRTrainer")
    asr = scalars("asr", "train_loss")
    with open(os.path.join(ck, "tracker.json")) as f:
        step = json.load(f)["asr"]["step"]
    per = max(len(asr) // SEED_EPOCHS["asr"], 1)  # steps of one epoch
    first, last = float(np.mean(asr[:per])), float(np.mean(asr[-per:]))
    print(f"cli.train ASRTrainer from the last relay: {len(asr)} steps of B={TRAIN_B} in "
          f"{secs:.1f} s, loss {asr[0]:.4f} -> {asr[-1]:.4f} (first epoch's mean {first:.4f}, "
          f"last epoch's {last:.4f}); tracker step {step}", flush=True)
    if not (f"Loading a pretrained model from {os.path.join(ck, 'asr.npz')}" in out
            and step == len(asr) >= 4 and np.isfinite(asr).all() and last < first):
        fail(f"cli.train ASRTrainer did not start from the relay, or its loss did not fall: "
             f"{asr}, tracker step {step}")
    return (train, held), os.path.join(ck, "asr.npz")


def lm_corpus(rng, idx, batch, chunk):
    """The char-LM phase's text: the normalised texts of the preprocessed
    tone corpus (``idx``: SOS + text + EOS, so that the LM learns where a
    transcript starts and ends, as fusion asks it), then seeded sentences of
    1-3 words of ``cli.mkdata.WORDS`` (the vocabulary of those texts)
    normalised alike, up to LM_BATCHES batches of ``batch`` chunks of
    ``chunk`` characters."""
    from ss_asr_tpu_torch.cli.mkdata import WORDS
    from ss_asr_tpu_torch.data.index import load_index
    from ss_asr_tpu_torch.vocab import normalize_string

    texts = [r["normalized_text"] for r in load_index(idx)]
    n_corpus, need = len(texts), LM_BATCHES * batch * chunk + 1
    size = sum(len(t) for t in texts)
    while size < need:
        texts.append(normalize_string(" ".join(rng.choice(WORDS, size=int(rng.integers(1, 4)))))[0])
        size += len(texts[-1])
    return "".join(texts), n_corpus, len(texts) - n_corpus


def run_main(main, argv):
    """A CLI's ``main(argv)`` in this process (so that the launch counters
    see its kernels) -> (return value, its standard output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def check_charlm(torch, rng, config, idx, tmp):
    """The char-LM at conf/default.yaml's width (H = 128, chunks of 200,
    B = 128, Adam 1e-4, tf 0.9) on a text corpus from the tone corpus's
    texts: one step on the card and on the CPU against float64 with the
    same seeded draws (the anchored rule); AUX_STEPS timed steps with a
    profile; ``python -m ss_asr_tpu_torch.cli.train CHARLMTrainer`` for
    LM_EPOCHS epochs, whose last epoch's mean loss per character must be
    below its first's; then ``cli.generate`` and ``cli.lm_predict`` on the
    trained ``char_lm.npz``.  Returns its path."""
    import numpy as np
    import yaml

    from ss_asr_tpu_torch import convert
    from ss_asr_tpu_torch.cli import generate, lm_predict
    from ss_asr_tpu_torch.data.lm_dataset import LMDataset
    from ss_asr_tpu_torch.models import charlm, las
    from ss_asr_tpu_torch.train.lm_trainer import CHARLMTrainer
    from ss_asr_tpu_torch.train.solver import make_paras
    from ss_asr_tpu_torch.utils.checkpoint import save_pytree

    c = copy.deepcopy(config)
    lmc = c["char_lm"]
    B, L = lmc["train_batch_size"], lmc["chunk_size"]
    text, n_corpus, n_more = lm_corpus(rng, idx, B, L)
    corpus = os.path.join(tmp, "lm_corpus.txt")
    with open(corpus, "w", encoding="utf-8") as f:
        f.write(text)
    lmc.update(train_index=corpus, n_epochs=LM_EPOCHS, logging_step=1, valid_step=20,
               save_step=10**6)
    ds = LMDataset(corpus, L)
    per = len(ds) // B
    print(f"char-LM corpus: {len(text)} characters ({n_corpus} texts of the tone corpus and "
          f"{n_more} seeded sentences of its words), {len(ds)} chunks of {L}, {per} batches of "
          f"{B} an epoch", flush=True)
    if per < 2:
        fail(f"char-LM corpus: {per} batches an epoch")
    cfg = charlm.CharLMConfig.from_dict(lmc["mdl"])
    tree = convert.init_charlm_numpy(SEED + 6, cfg)

    def lm_trainer(name, dev):
        paras = make_paras(name=name, logdir=os.path.join(tmp, "runs"),
                           ckpdir=os.path.join(tmp, "result"), seed=SEED, verbose=False)
        save_pytree(os.path.join(tmp, "result", name, "char_lm.npz"), tree)
        t = CHARLMTrainer(c, paras, device=dev)
        t.load_data()
        t.set_model()
        return t

    ts = [lm_trainer(f"lm_{tag}", dev) for tag, dev in (("card", DEVICE), ("cpu", "cpu"),
                                                        ("f64", "cpu"))]
    ts[2].lm.double()
    y = torch.from_numpy(next(ds.iter_batches(B, seed=SEED))[1]).long()
    gen = torch.Generator().manual_seed(SEED)
    tf_draws, gumbel = las.draw_scheduled_sampling(L, B, cfg.tf_rate, cfg, gen, device="cpu")
    anchored_losses(torch, f"char-LM step B={B} L={L} H={cfg.hidden_size} tf {cfg.tf_rate}", ts,
                    lambda t, dev: t.loss_of(y.to(dev), tf_draws.to(dev), gumbel.to(dev).to(
                        t.lm.out.weight.dtype))[0])
    card, yd = ts[0], y.to(DEVICE)
    timed_steps(torch, "char-LM step (unroll of 200 + backward + clip + Adam)", card,
                [card.optim], lambda: card.step(yd), B, ())

    path = os.path.join(tmp, "lm.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(c, f)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ss_asr_tpu_torch.cli.train", "CHARLMTrainer", "lm", path,
         os.path.join(tmp, "lm_runs"), os.path.join(tmp, "lm_result"), "--seed", str(SEED),
         "--verbose", "0", "--device", DEVICE],
        cwd=HERE, env={**os.environ, "PYTHONPATH": HERE}, capture_output=True, text=True,
        timeout=900)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"cli.train CHARLMTrainer exited {proc.returncode}: {proc.stderr[-3000:]}")
    with open(os.path.join(tmp, "lm_runs", "lm", "char_lm", "metrics.jsonl")) as f:
        losses = [r["value"] for r in map(json.loads, f) if r["key"] == "char_lm_train_loss"]
    first, last = float(np.mean(losses[:per])), float(np.mean(losses[-per:]))
    print(f"cli.train CHARLMTrainer: {len(losses)} steps of B={B} in {secs:.1f} s (process "
          f"included); loss per character {losses[0]:.4f} -> {losses[-1]:.4f} (first epoch's mean "
          f"{first:.4f}, last epoch's {last:.4f})", flush=True)
    lm_path = os.path.join(tmp, "lm_result", "lm", "char_lm.npz")
    if not (len(losses) == LM_EPOCHS * per and np.isfinite(losses).all() and last < first
            and os.path.isfile(lm_path)):
        fail(f"cli.train CHARLMTrainer: {len(losses)} losses, {first} -> {last}, "
             f"char_lm.npz written {os.path.isfile(lm_path)}")
    common = ["--name", "lm", "--config", path, "--logdir", os.path.join(tmp, "lm_runs"),
              "--ckpdir", os.path.join(tmp, "lm_result"), "--verbose", "0", "--device", DEVICE]
    _, out = run_main(generate.main, [*common, "--start", "aba ", "--length", "80"])
    gen = out.strip().splitlines()[-1]
    print(f"cli.generate (temp 0.6): {gen!r}", flush=True)
    if not (gen.startswith("aba ") and len(gen) == 84):
        fail(f"cli.generate printed {out!r}")
    _, out = run_main(lm_predict.main, [*common, "--text", "aba fig dig hide"])
    lines = out.strip().splitlines()
    print(f"cli.lm_predict: {lines[0]!r} {'; '.join(lines[1:])}", flush=True)
    if not (len(lines) == 12 and lines[-1].startswith("tf_rate=1: ")):
        fail(f"cli.lm_predict printed {out!r}")
    return lm_path


def direct_hyps(torch, config, index, asr_path, lm_path, beam, lm_weight):
    """The test index's transcripts from direct ``greedy_decode_early_exit``
    / ``beam_decode`` calls on the tester's batches and step caps."""
    from ss_asr_tpu_torch import convert
    from ss_asr_tpu_torch.data.asr_dataset import ASRDataset, round_up
    from ss_asr_tpu_torch.decode.beam import beam_decode
    from ss_asr_tpu_torch.decode.greedy import greedy_decode_early_exit
    from ss_asr_tpu_torch.models import charlm, las
    from ss_asr_tpu_torch.utils.checkpoint import load_pytree

    import numpy as np

    c = config["asr"]
    model = las.LAS(las.ASRConfig.from_dict(c["mdl"]))
    model.load_state_dict(convert.asr_state_from_params(load_pytree(asr_path)))
    model = model.to(DEVICE).eval()
    lm = None
    if lm_weight:
        lm = charlm.CharLM(charlm.CharLMConfig.from_dict(config["char_lm"]["mdl"]))
        lm.load_state_dict(convert.charlm_state_from_params(load_pytree(lm_path)))
        lm = lm.to(DEVICE).eval()
    ds = ASRDataset(index, batch_size=TEST_B, t_bucket=c["t_bucket"], l_bucket=c["l_bucket"])
    hyps = []
    for b in ds.iter_batches(drop_last=False, shuffle=False):
        ms = min(200, max(8, round_up(int(c["max_decode_step_ratio"] * b.x.shape[1]), 8)))
        x, lens = torch.from_numpy(b.x).to(DEVICE), torch.from_numpy(b.x_lens).to(DEVICE)
        if beam > 1:
            toks, _ = beam_decode(model, x, lens, beam, ms, lm, lm_weight)
        else:
            with torch.inference_mode():
                toks = greedy_decode_early_exit(model, x, lens, ms, lm, lm_weight)[0].cpu().numpy()
        valid = b.valid if b.valid is not None else np.ones(len(toks), bool)
        hyps += [ds.mapper.translate(toks[i]) for i in range(len(toks)) if valid[i]]
    return hyps


TEST_RUNS = (("greedy", {"decode_beam_size": 1, "decode_lm_weight": 0.0},
              ("lstm_fwd", "greedy_decode")),
             ("default", {}, ("lstm_fwd", "beam_decode_lm")))


def tester_runs(torch, config, held, tmp, name, lm_path, when):
    """``cli.train ASRTester`` on the held-out index, greedy without the LM
    and under conf/default.yaml's decode settings (beam 3 + LM 0.5, step
    cap 0.25 of the frames), each with the launch counters zeroed just
    before and read just after; every transcript equal to the direct decode
    calls'.  Returns ({run: metrics}, {run: (hypothesis, reference) pairs},
    {path: launches})."""
    import yaml

    from ss_asr_tpu_torch.cli import train

    ck = os.path.join(tmp, "test_result", name)
    metrics, texts, launches = {}, {}, {}
    for run, overrides, need in TEST_RUNS:
        c = copy.deepcopy(config)
        c["asr"].update(test_index=held, test_batch_size=TEST_B, **overrides)
        path = os.path.join(tmp, f"test_{name}_{run}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(c, f)
        zero_launches()
        t0 = time.perf_counter()
        run_main(train.main, ["ASRTester", name, path, os.path.join(tmp, "test_runs"),
                              os.path.join(tmp, "test_result"), "--seed", str(SEED), "--verbose",
                              "0", "--device", DEVICE])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        tag = f"tester {run} ({when})"
        launches[tag] = read_launches()
        a = c["asr"]
        stem = f"decode_beam_{a['decode_beam_size']}_len_{a['max_decode_step_ratio']}_lm" \
               f"{a['decode_lm_weight']}"
        with open(os.path.join(ck, stem + ".txt"), encoding="utf-8") as f:
            pairs = [line.rstrip("\n").split("\t") for line in f]
        with open(os.path.join(ck, stem + "_metrics.json")) as f:
            m = json.load(f)
        want = direct_hyps(torch, c, held, os.path.join(ck, "asr.npz"), lm_path,
                           a["decode_beam_size"], a["decode_lm_weight"])
        print(f"{tag}: {m['n']} utterances in {secs:.3f} s ({m['n'] / secs:.2f} utt/s, the "
              f"CLI's set-up included), acc {m['acc']:.4f} WER {m['wer']:.4f} CER "
              f"{m['cer']:.4f}; transcripts equal the direct calls: "
              f"{[h for h, _ in pairs] == want}; launches "
              f"{ {k: v for k, v in launches[tag].items() if v} }", flush=True)
        for h, r in pairs[:3]:
            print(f"{tag}: {h!r} for {r!r}", flush=True)
        if [h for h, _ in pairs] != want or m["n"] != len(want) or m["n"] < 1:
            fail(f"{tag}: transcripts differ from the direct calls")
        for k in need:
            if launches[tag][k] < 1:
                fail(f"{tag}: launched {k} {launches[tag][k]} times")
        require_cluster_route(tag, launches[tag])
        metrics[run], texts[run] = m, pairs
    return metrics, texts, launches


def check_tester_and_tools(torch, config, split, relay, lm_path, tmp):
    """The tester on the held-out side of the tone corpus with the relay of
    the Seed chain and ASRTrainer, and the trained LM; a bounded
    ``cli.train ASRTrainer`` run on the train side (``keep_snapshots: 2``);
    the tester again, whose greedy CER must be below the first one's; the
    new checkpoint and the LM behind the server (greedy + LM, the default
    decode); then ``cli.pseudolabel`` on PSEUDO_UTTS held-out wavs with the new checkpoint
    and the LM (its kept rows must load through ``ASRDataset``), and
    ``cli.avg_ckpt`` of the run's two snapshots against a float64 mean.
    Returns ({path: launches}, the trained ASR checkpoint, the held-out
    signals it served)."""
    import numpy as np
    import yaml

    from ss_asr_tpu_torch.api import Transcriber
    from ss_asr_tpu_torch.cli import avg_ckpt, pseudolabel
    from ss_asr_tpu_torch.data.asr_dataset import ASRDataset
    from ss_asr_tpu_torch.data.audio import load_wav
    from ss_asr_tpu_torch.data.index import load_index
    from ss_asr_tpu_torch.utils import checkpoint as ckpt

    train_idx, held = split
    ck = os.path.join(tmp, "test_result", "test")
    os.makedirs(ck)
    shutil.copyfile(relay, os.path.join(ck, "asr.npz"))
    shutil.copyfile(lm_path, os.path.join(ck, "char_lm.npz"))
    before, _, launches = tester_runs(torch, config, held, tmp, "test", lm_path, "before")

    extra = os.path.join(tmp, "extra_result", "extra")
    os.makedirs(extra)
    shutil.copyfile(relay, os.path.join(extra, "asr.npz"))
    c = train_config(config, split, EXTRA_EPOCHS)
    c["asr"].update(keep_snapshots=2, save_step=100, logging_step=20)
    path = os.path.join(tmp, "extra.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(c, f)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ss_asr_tpu_torch.cli.train", "ASRTrainer", "extra", path,
         os.path.join(tmp, "extra_runs"), os.path.join(tmp, "extra_result"), "--seed", str(SEED),
         "--verbose", "0", "--device", DEVICE],
        cwd=HERE, env={**os.environ, "PYTHONPATH": HERE}, capture_output=True, text=True,
        timeout=900)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"cli.train ASRTrainer (extra) exited {proc.returncode}: {proc.stderr[-3000:]}")
    with open(os.path.join(extra, "tracker.json")) as f:
        steps = json.load(f)["asr"]["step"]
    with open(os.path.join(tmp, "extra_runs", "extra", "asr", "metrics.jsonl")) as f:
        losses = [r["value"] for r in map(json.loads, f) if r["key"] == "asr_train_loss"]
    print(f"cli.train ASRTrainer (extra, from the relay): {steps} steps of B={TRAIN_B} on "
          f"{len(load_index(train_idx))} train rows in {secs:.1f} s (process included); loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    shutil.copyfile(os.path.join(extra, "asr.npz"), os.path.join(ck, "asr.npz"))
    after, texts, more = tester_runs(torch, config, held, tmp, "test", lm_path, "after")
    launches.update(more)
    differ = [(g, d, r) for (g, r), (d, _) in zip(texts["greedy"], texts["default"]) if g != d]
    print(f"tester (after): greedy and default differ on {len(differ)} of "
          f"{len(texts['greedy'])} utterances (greedy, default, reference): {differ[:6]}",
          flush=True)
    for run in before:
        print(f"tester {run}: CER {before[run]['cer']:.4f} -> {after[run]['cer']:.4f}, WER "
              f"{before[run]['wer']:.4f} -> {after[run]['wer']:.4f} after the extra run",
              flush=True)
    if not after["greedy"]["cer"] < before["greedy"]["cer"]:
        fail(f"the extra ASRTrainer run did not lower the greedy CER: {before} -> {after}")

    # the trained ASR and the trained LM behind the server: greedy + LM 0.5 and the default
    wavs = [r["wav_fname"] for r in load_index(held)][:PSEUDO_UTTS]
    sigs = [load_wav(w, target_sr=PRE_SR)[1] for w in wavs]
    for tag, kw, need in (("serve+lm trained", {"beam_size": 1, "lm_weight": 0.5},
                           ("fbank", "lstm_fwd", "greedy_decode_lm")),
                          ("serve default trained", {}, ("fbank", "lstm_fwd", "beam_decode_lm"))):
        t = Transcriber.from_checkpoint(os.path.join(ck, "asr.npz"), config, lm_path=lm_path,
                                        device=DEVICE, sr=PRE_SR, **kw)
        launches.update(serve_phase(torch, tag, t, sigs, need, sr=PRE_SR, min_chars=3))

    out_dir = os.path.join(tmp, "pseudo")
    zero_launches()
    t0 = time.perf_counter()
    rc, out = run_main(pseudolabel.main, [
        os.path.join(extra, "asr.npz"), out_dir, *wavs, "--config",
        os.path.join(HERE, "conf", "default.yaml"), "--lm", lm_path, "--sr", str(PRE_SR),
        "--batch", str(TEST_B), "--min-avg-logprob", str(PSEUDO_FLOOR), "--device", DEVICE])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches["pseudolabel"] = read_launches()
    summary = json.loads(out.strip().splitlines()[-1])
    ds = ASRDataset(summary["index"], batch_size=TEST_B)
    loaded = sum(int(b.valid.sum()) if b.valid is not None else len(b.x)
                 for b in ds.iter_batches(drop_last=False))
    print(f"cli.pseudolabel (beam 3 + LM 0.5, floor {PSEUDO_FLOOR}) in {secs:.3f} s: {summary}; "
          f"ASRDataset loads {loaded} rows; launches "
          f"{ {k: v for k, v in launches['pseudolabel'].items() if v} }", flush=True)
    if rc != 0 or summary["n_kept"] < 1 or loaded != summary["n_kept"]:
        fail(f"cli.pseudolabel: exit {rc}, {summary}, ASRDataset loaded {loaded} rows")
    for k in ("fbank", "lstm_fwd", "beam_decode_lm", "spell_fwd"):
        if launches["pseudolabel"][k] < 1:
            fail(f"cli.pseudolabel: launched {k} {launches['pseudolabel'][k]} times")
    require_cluster_route("pseudolabel", launches["pseudolabel"])

    snaps = [p for _, p in ckpt.list_snapshots(extra, "asr")]
    avg = os.path.join(tmp, "avg.npz")
    _, out = run_main(avg_ckpt.main, ["--out", avg, "--ckpdir", extra, "--module", "asr",
                                      "--last", "2"])
    got = ckpt._flatten(ckpt.load_pytree(avg))
    trees = [ckpt._flatten(ckpt.load_pytree(p)) for p in snaps]
    worst = 0.0
    for k, v in got.items():
        mean64 = (trees[0][k].astype(np.float64) + trees[1][k].astype(np.float64)) / 2
        ulp = np.spacing(np.abs(mean64).astype(np.float32)).astype(np.float64)
        worst = max(worst, float(np.max(np.abs(v.astype(np.float64) - mean64) / ulp)))
    print(f"cli.avg_ckpt of {[os.path.basename(p) for p in snaps]}: {len(got)} leaves, each within "
          f"{worst:.3f} float32 ulp of the float64 mean", flush=True)
    if len(snaps) != 2 or set(got) != set(trees[0]) or worst > 0.5:
        fail(f"cli.avg_ckpt: {len(snaps)} snapshots, worst {worst} ulp")
    return launches, os.path.join(ck, "asr.npz"), sigs


# ---------------------------------------------------------------------------
# phase 11: the trainers' options (accumulation, schedules, SpecAugment) and import_ckpt

AUG_TOL = 1e-6  # SpecAugment on the card against the CPU: relative, on the masked values
AUG_ADAPTIVE = {"n_time_masks": 10, "adaptive_size_ratio": 0.05, "adaptive_number_ratio": 0.04}
AUGMENT = {"n_freq_masks": 2, "freq_mask_width": 8, "n_time_masks": 2, "time_mask_width": 16}
ACCUM = 2  # the flagship update as ACCUM micro-batches of TRAIN_B // ACCUM
ACCUM_UPDATES = 5  # timed accumulated updates (the median is reported)
SCHEDULE = {"warmup_steps": 3, "decay_steps": 5, "end_scale": 0.1}
SCHEDULE_UPDATES = 10
RATE_TOL = 1e-6
OPT_CLI_STEPS = 3  # odd: the first cli.train run stops in the middle of an accumulation
AUX_MICRO_B = 8  # the micro-batch of the auxiliary trainers' accumulated updates
LM_MICRO_B = 16  # ... and of the char-LM's


def float64_optim(opt):
    """A fresh optimizer's slots and running mean in the dtype its
    parameters have now (after ``module.double()``)."""
    opt.state = {s: {k: opt.params[k].new_zeros(opt.params[k].shape) for k in v}
                 for s, v in opt.state.items()}
    opt.acc_grads = {k: opt.params[k].new_zeros(opt.params[k].shape) for k in opt.acc_grads}


def check_augment(torch, rng):
    """SpecAugment at the flagship (B = 32, T = 512, F = 40), the default
    masks and the adaptive ones, on the card and on the CPU from the same
    draws: the masks equal, the values within AUG_TOL relative; the
    card's time from CUDA events."""
    import numpy as np

    from ss_asr_tpu_torch.ops import augment

    lens = rng.integers(TRAIN_MIN_FRAMES, FRAMES + 1, size=TRAIN_B)
    lens[0] = FRAMES
    x = (3.0 * rng.standard_normal((TRAIN_B, FRAMES, 40)) - 5.0).astype(np.float32)
    x[np.arange(FRAMES)[None, :] >= lens[:, None]] = 0.0
    xc, lc = torch.from_numpy(x), torch.from_numpy(lens)
    xd, ld = xc.to(DEVICE), lc.to(DEVICE)
    gen = torch.Generator().manual_seed(SEED)
    for tag, d in (("default", AUGMENT), ("adaptive", {**AUGMENT, **AUG_ADAPTIVE})):
        cfg = augment.SpecAugmentConfig(**d)
        draws = augment.draw_uniforms(TRAIN_B, cfg, gen, "cpu")
        dd = tuple(u.to(DEVICE) for u in draws)
        want = augment.spec_augment(xc, lc, cfg, draws=draws)
        got = augment.spec_augment(xd, ld, cfg, draws=dd).cpu()
        masked = want != xc
        same_masks = torch.equal(got != xc, masked)
        err = float(((got - want).abs() / want.abs().clamp(min=1e-30))[masked].max())
        ms = cuda_ms(torch, lambda: augment.spec_augment(xd, ld, cfg, draws=dd), reps=20)
        print(f"SpecAugment {tag} B={TRAIN_B} T={FRAMES} F=40: masks equal the CPU's "
              f"{same_masks}, {float(masked.float().mean()):.4f} of the features masked, masked "
              f"values rel err {err:.3e}; card {ms:.4f} ms", flush=True)
        if not (same_masks and masked.any() and err <= AUG_TOL):
            fail(f"SpecAugment {tag}: masks equal {same_masks}, rel err {err:.3e}")


def update_errors(torch, tag, ts, optims, before, excused=()):
    """One accumulated update on the card (``ts[0]``), on the CPU and in
    float64 on the CPU: each trained parameter's update and each slot of
    the optimizers by the anchored rule (the card's relative L2 error
    against float64 at most ANCHOR_RATIO times the CPU float32's, or below
    STEP_FLOOR), except the names in ``excused``, whose gradients passed
    the anchored checks only through a flipped max-pool window or ReLU (a
    discrete choice moves their update as a whole; printed, not held).
    Every optimizer must have ended its first update, and every parameter
    outside the masks must be bit-unchanged on the card."""
    worst, bad, loose = (0.0, 0.0, ""), [], []
    for i, opt in enumerate(optims(ts[0])):
        trio = [optims(t)[i] for t in ts]
        if any((o.gradient_step, o.mini_step) != (1, 0) for o in trio):
            fail(f"{tag}: gradient_step / mini_step {[(o.gradient_step, o.mini_step) for o in trio]}")
        rows = [(n, n, [o.params[n].detach().cpu().double() - before[j][n]
                        for j, o in enumerate(trio)]) for n in sorted(opt.mask)]
        rows += [(f"{s} {n}", n, [o.state[s][n].cpu().double() for o in trio])
                 for s in opt.slots for n in sorted(opt.mask)]
        for name, param, (card, cpu, ref) in rows:
            k, c = rel_l2(torch, card, ref), rel_l2(torch, cpu, ref)
            if param in excused:
                loose.append(f"{name} {k:.3e}")
                continue
            worst = max(worst, (k, c, name))
            if not k <= max(ANCHOR_RATIO * c, STEP_FLOOR):
                bad.append(f"{name} (card {k:.3e}, CPU {c:.3e})")
    trained = set().union(*(o.mask for o in optims(ts[0])))
    moved = [n for n, p in optims(ts[0])[0].params.items()
             if n not in trained and not torch.equal(p.detach().cpu().double(), before[0][n])]
    print(f"{tag}: one accumulated update ({ACCUM} micro-batches), every update and slot against "
          f"float64: worst card rel L2 {worst[0]:.3e} (CPU float32 {worst[1]:.3e}, {worst[2]})"
          + (f"; behind a flipped max-pool window or ReLU, not held: {loose}" if loose else ""),
          flush=True)
    if moved:
        fail(f"{tag}: parameters outside the masks moved: {moved}")
    if bad:
        fail(f"{tag}: card error against float64 above {ANCHOR_RATIO} x the CPU float32's and "
             f"{STEP_FLOOR}: {bad}")


def snapshot(torch, ts, optims):
    """Each trainer's parameters under its optimizers' names, as float64 on the host."""
    return [{n: p.detach().cpu().double().clone() for o in optims(t) for n, p in o.params.items()}
            for t in ts]


def check_accumulation(torch, rng, config, asr_tree, tmp):
    """The flagship update as ACCUM micro-batches of TRAIN_B // ACCUM
    (``accum_steps: 2``, teacher-forced so that the micro-batches and the
    whole batch see the same feedback) on the card, the CPU and in float64:
    the update and the Adadelta slots by the anchored rule, and the same
    update as one batch of TRAIN_B on the card against the same float64
    run.  Then the accumulated update with SpecAugment at tf 0.9 (frontend
    from the waveforms + augment + forward + backward per micro-batch, clip
    + Adadelta once) timed, its launches counted, and profiled beside the
    whole-batch step.  Returns {path: launches}."""
    from ss_asr_tpu_torch.ops.frontend import log_mel_fbank_batch

    wave, n, y = train_batch(torch, rng)
    with torch.no_grad():
        x, x_lens = log_mel_fbank_batch(wave, n, SR)
    mb = TRAIN_B // ACCUM
    parts = [slice(i * mb, (i + 1) * mb) for i in range(ACCUM)]
    c = copy.deepcopy(config)
    c["asr"]["mdl"]["tf_rate"] = 1.0
    c["asr"]["opt"]["accum_steps"] = ACCUM
    ts = [trainer(c, tmp, f"accum_{tag}", asr_tree, dev)
          for tag, dev in (("card", DEVICE), ("cpu", "cpu"), ("f64", "cpu"))]
    ts[2].model.double()
    float64_optim(ts[2].optim)
    before = snapshot(torch, ts, lambda t: [t.optim])
    for t, dev in zip(ts, (DEVICE, "cpu", "cpu")):
        dt = next(t.model.parameters()).dtype
        for sl in parts:
            t.step(x[sl].to(dev).to(dt), x_lens[sl].to(dev), y[sl].to(dev))
    update_errors(torch, f"ASR update {ACCUM} x B={mb} T={x.shape[1]} L={TRAIN_L}", ts,
                  lambda t: [t.optim], before)
    c1 = copy.deepcopy(c)
    c1["asr"]["opt"]["accum_steps"] = 1
    whole = trainer(c1, tmp, "accum_whole", asr_tree, DEVICE)
    whole.step(x, x_lens, y)
    worst, bad = (0.0, ""), []
    for name in sorted(whole.optim.mask):
        got = whole.optim.params[name].detach().cpu().double() - before[0][name]
        ref = ts[2].optim.params[name].detach().cpu().double() - before[2][name]
        cpu = ts[1].optim.params[name].detach().cpu().double() - before[1][name]
        k, cc = rel_l2(torch, got, ref), rel_l2(torch, cpu, ref)
        worst = max(worst, (k, name))
        if not k <= max(ANCHOR_RATIO * cc, STEP_FLOOR):
            bad.append(f"{name} (card B={TRAIN_B} {k:.3e}, CPU {ACCUM} x {mb} {cc:.3e})")
    print(f"ASR update as one batch of B={TRAIN_B} on the card against the float64 run of "
          f"{ACCUM} x {mb}: worst rel L2 {worst[0]:.3e} ({worst[1]})", flush=True)
    if bad:
        fail(f"ASR update of B={TRAIN_B} against {ACCUM} x {mb} in float64: {bad}")

    # timed: the options as a user sets them (tf 0.9, SpecAugment, accumulation)
    ct = copy.deepcopy(config)
    ct["asr"]["augment"] = dict(AUGMENT)
    ct["asr"]["opt"]["accum_steps"] = ACCUM
    acc = trainer(ct, tmp, "accum_timed", asr_tree, DEVICE)
    ct1 = copy.deepcopy(ct)
    ct1["asr"]["opt"]["accum_steps"] = 1
    one = trainer(ct1, tmp, "accum_one", asr_tree, DEVICE)

    def update():
        for sl in parts:
            with torch.no_grad():
                fb, fl = log_mel_fbank_batch(wave[sl], n[sl], SR)
            acc.step(fb, fl, y[sl])

    def step():
        with torch.no_grad():
            fb, fl = log_mel_fbank_batch(wave, n, SR)
        one.step(fb, fl, y)

    readings = {}
    for tag, fn, t in ((f"accumulated update {ACCUM} x B={mb}", update, acc),
                       (f"one step B={TRAIN_B}", step, one)):
        fn()  # warm-up
        torch.cuda.synchronize()
        zero_launches()
        updates0, times = t.optim.gradient_step, []
        for _ in range(ACCUM_UPDATES):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches()
        if t is acc and (t.optim.gradient_step - updates0, t.optim.mini_step) != (ACCUM_UPDATES, 0):
            fail(f"{tag}: {t.optim.gradient_step - updates0} updates, mini_step "
                 f"{t.optim.mini_step} after {ACCUM_UPDATES}")
        ms = statistics.median(times)
        print(f"{tag} (frontend + SpecAugment + forward + backward, clip + Adadelta once, "
              f"tf 0.9): median of {ACCUM_UPDATES} {ms:.3f} ms wall, {TRAIN_B / ms * 1e3:.1f} "
              f"utt/s (min {min(times):.3f}, max {max(times):.3f}); launches per update "
              f"{ {k: v // ACCUM_UPDATES for k, v in launches.items() if v} }", flush=True)
        for name in ("fbank", "lstm_fwd", "lstm_bwd", "spell_fwd", "spell_bwd"):
            if launches[name] < ACCUM_UPDATES:
                fail(f"{tag}: launched {name} {launches[name]} times in {ACCUM_UPDATES} updates")
        require_cluster_route(tag, launches)
        readings[tag] = (ms, profile_steps(torch, fn, 2), launches)
    (a_ms, a_prof, a_l), (o_ms, o_prof, _) = readings.values()
    idle = [f"{p[2]:.3f}" if p else "not measured" for p in (a_prof, o_prof)]
    print(f"accumulated update {ACCUM} x B={mb}: {a_ms:.3f} ms, idle share {idle[0]}; one step "
          f"of B={TRAIN_B}: {o_ms:.3f} ms, idle share {idle[1]}", flush=True)
    return {"accumulated update": a_l}


def check_schedule(torch):
    """A warm-up / cosine schedule on the card: SGD on a zeroed parameter
    with a gradient of ones, so that the parameter after each update is
    minus that update's rate; each rate within RATE_TOL of the float64
    formula (``make_schedule(..., dtype=np.float64)``)."""
    import numpy as np

    from ss_asr_tpu_torch.train.optim import Optimizer, make_schedule

    p = torch.nn.Parameter(torch.zeros(4, device=DEVICE))
    opt = Optimizer([("w", p)], "SGD", 1.0, **SCHEDULE)
    f64 = make_schedule(1.0, dtype=np.float64, **SCHEDULE)
    got, want = [], []
    for u in range(SCHEDULE_UPDATES):
        with torch.no_grad():
            p.zero_()
        p.grad = torch.ones_like(p)
        opt.step()
        got.append(0.0 - float(p.detach()[0]))
        want.append(f64(u))
    err = max(abs(g - w) for g, w in zip(got, want))
    print(f"schedule {SCHEDULE} (SGD, rate 1.0) on the card, {SCHEDULE_UPDATES} updates: rates "
          f"{[round(g, 7) for g in got]}; worst |card - float64 formula| {err:.3e}", flush=True)
    if err > RATE_TOL or opt.sched_count != SCHEDULE_UPDATES:
        fail(f"schedule: worst rate error {err:.3e}, count {opt.sched_count}")


def check_cli_options(rng, config, tmp):
    """``cli.train ASRTrainer`` as a subprocess with ``accum_steps: 2``, a
    warm-up / cosine schedule and ``asr.augment`` for OPT_CLI_STEPS (odd)
    micro-steps: its ``asr_opt.npz`` holds ``mini_step`` 1 and a non-zero
    running mean; a trainer built on it reads every leaf back; a second
    invocation resumes and ends the accumulation."""
    import numpy as np
    import yaml

    from ss_asr_tpu_torch import convert
    from ss_asr_tpu_torch.train.asr_trainer import ASRTrainer
    from ss_asr_tpu_torch.train.solver import make_paras
    from ss_asr_tpu_torch.utils import checkpoint as ckpt

    root = os.path.join(tmp, "opt_corpus")
    os.makedirs(root)
    split = held_out_split(write_corpus(rng, root, CLI_UTTS))
    runs, result = os.path.join(tmp, "opt_runs"), os.path.join(tmp, "opt_result")
    ck = os.path.join(result, "opts")

    def cfg(n_epochs):
        c = train_config(config, split, n_epochs)
        c["asr"]["opt"].update(accum_steps=ACCUM, **SCHEDULE)
        c["asr"]["augment"] = dict(AUGMENT)
        return c

    def run(n_epochs):
        path = os.path.join(tmp, f"opts_{n_epochs}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg(n_epochs), f)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ss_asr_tpu_torch.cli.train", "ASRTrainer", "opts", path, runs,
             result, "--seed", str(SEED), "--verbose", "0", "--device", DEVICE],
            cwd=HERE, env={**os.environ, "PYTHONPATH": HERE}, capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            fail(f"cli.train (options) exited {proc.returncode}: {proc.stderr[-3000:]}")
        with open(os.path.join(ck, "tracker.json")) as f:
            step = json.load(f)["asr"]["step"]
        return time.perf_counter() - t0, step, ckpt.load_opt_state(os.path.join(ck, "asr_opt.npz"))

    secs, step, leaves = run(OPT_CLI_STEPS)
    acc = leaves[-36:]  # the running mean of the LAS's 36 leaves closes the layout
    mean_abs = float(np.mean([np.abs(a).mean() for a in acc]))
    print(f"cli.train ASRTrainer (accum_steps {ACCUM}, {SCHEDULE}, augment): {step} micro-steps "
          f"in {secs:.1f} s (process included); asr_opt.npz: {len(leaves)} leaves, mini_step "
          f"{int(leaves[3])}, gradient_step {int(leaves[4])}, schedule count "
          f"{int(leaves[5 + 2 * 36])}, running mean |g| {mean_abs:.3e}", flush=True)
    if not (step == OPT_CLI_STEPS and len(leaves) == 5 + 2 * 36 + 1 + 36 and int(leaves[3]) == 1
            and int(leaves[4]) == 1 and int(leaves[5 + 2 * 36]) == 1 and mean_abs > 0):
        fail(f"cli.train (options): step {step}, {len(leaves)} leaves, mini_step {leaves[3]}")
    paras = make_paras(name="opts", logdir=runs, ckpdir=result, seed=SEED, verbose=False)
    t = ASRTrainer(cfg(1), paras, device=DEVICE)
    t.set_model()
    got = convert.asr_opt_state_leaves(t.optim, t.model)
    t.lg.close()
    same = len(got) == len(leaves) and all(
        g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, leaves))
    print(f"ASRTrainer on that checkpoint: {len(got)} optimizer leaves read back, equal leaf for "
          f"leaf {same}; mini_step {t.optim.mini_step}", flush=True)
    if not (same and t.optim.mini_step == 1):
        fail("the resumed trainer did not read the optimizer state back leaf for leaf")
    secs, step, leaves = run(OPT_CLI_STEPS + 1)
    with open(os.path.join(runs, "opts", "asr", "metrics.jsonl")) as f:
        recs = [r for r in map(json.loads, f) if r["key"] == "asr_train_loss"]
    print(f"cli.train resumed: steps {[r['step'] for r in recs[OPT_CLI_STEPS:]]} in {secs:.1f} s; "
          f"mini_step {int(leaves[3])}, gradient_step {int(leaves[4])}; losses "
          f"{[round(r['value'], 4) for r in recs]}", flush=True)
    if not (step == 2 * OPT_CLI_STEPS + 1 and int(leaves[4]) == (2 * OPT_CLI_STEPS + 1) // ACCUM
            and int(leaves[3]) == 1 and np.isfinite([r["value"] for r in recs]).all()
            and [r["step"] for r in recs] == list(range(2 * OPT_CLI_STEPS + 1))):
        fail(f"cli.train (options) did not resume: step {step}, {[r['step'] for r in recs]}")


def check_aux_accumulation(torch, rng, config, asr_tree, tmp):
    """One accumulated update (``accum_steps: 2``, micro-batches of
    AUX_MICRO_B; the char-LM's of LM_MICRO_B chunks) of each of the TAE,
    SAE, ADV (G and D) and char-LM trainers at the full width on the card,
    the CPU and in float64: each micro-batch's loss and gradients by the
    anchored rule (with its max-pool and ReLU witnesses), then the update
    and the slots (``update_errors``)."""
    from ss_asr_tpu_torch import convert
    from ss_asr_tpu_torch.models import charlm, las
    from ss_asr_tpu_torch.models import discriminator as disc_mod
    from ss_asr_tpu_torch.models import speech_autoencoder as sae_mod
    from ss_asr_tpu_torch.models import text_autoencoder as tae_mod
    from ss_asr_tpu_torch.ops.frontend import log_mel_fbank_batch
    from ss_asr_tpu_torch.train.adv_trainer import ADVTrainer
    from ss_asr_tpu_torch.train.lm_trainer import CHARLMTrainer
    from ss_asr_tpu_torch.train.sae_trainer import SAETrainer
    from ss_asr_tpu_torch.train.solver import make_paras
    from ss_asr_tpu_torch.train.tae_trainer import TAETrainer
    from ss_asr_tpu_torch.utils.checkpoint import save_pytree

    c = copy.deepcopy(config)
    for sec in (c["tae"]["opt"], c["sae"]["opt"], c["adv"]["G_opt"], c["adv"]["D_opt"],
                c["char_lm"]["opt"]):
        sec["accum_steps"] = ACCUM
    asr_cfg = las.ASRConfig.from_dict(c["asr"]["mdl"])
    tae_tree = convert.init_tae_numpy(SEED + 13, tae_mod.TAEConfig.from_dict(c["tae"]["mdl"]))
    sae_cfg = sae_mod.SAEConfig.from_dict({**c["sae"]["mdl"],
                                           "listener_out_dim": asr_cfg.enc_out_dim})
    sae_params, sae_bn = convert.init_sae_numpy(SEED + 14, sae_cfg)
    disc_tree = convert.init_disc_numpy(SEED + 15, disc_mod.DiscriminatorConfig.from_dict(
        {**c["adv"]["mdl"], "in_dim": asr_cfg.enc_out_dim}))
    B = ACCUM * AUX_MICRO_B
    parts = [slice(i * AUX_MICRO_B, (i + 1) * AUX_MICRO_B) for i in range(ACCUM)]
    wave, n, _ = train_batch(torch, rng)
    with torch.no_grad():
        x, x_lens = log_mel_fbank_batch(wave[:B], n[:B], SR)

    def three(cls, name, trees, optims):
        ts = [aux_trainer(cls, c, tmp, f"acc_{name}_{tag}", trees, dev)
              for tag, dev in (("card", DEVICE), ("cpu", "cpu"), ("f64", "cpu"))]
        for m in ts[2].models.values():
            m.double()
        for o in optims(ts[2]):
            float64_optim(o)
        return ts

    def run(tag, ts, optims, micro):
        """``micro(ts, sl)`` checks one micro-batch and leaves its gradients
        -> the names it let pass through a witness; then each optimizer steps."""
        before, excused = snapshot(torch, ts, optims), set()
        for sl in parts:
            excused |= set(micro(ts, sl))
            for t in ts:
                for o in optims(t):
                    o.step()
        update_errors(torch, tag, ts, optims, before, excused)

    def dt(t, key):
        return next(t.models[key].parameters()).dtype

    # TAE
    y, _, yn, nl = text_batch(torch, rng, B, c["tae"]["drop_rate"])
    ts = three(TAETrainer, "tae", {"asr": asr_tree, "tae": tae_tree}, lambda t: [t.optim])
    run(f"TAE (Adam) {ACCUM} x B={AUX_MICRO_B}", ts, lambda t: [t.optim],
        lambda ts, sl: anchored_losses(
            torch, f"TAE micro-batch {sl.start // AUX_MICRO_B}", ts,
            lambda t, dev: t.loss_of(y[sl].to(dev), yn[sl].to(dev), nl[sl].to(dev))[0]))
    # SAE, with listener_lr_scale from the config (an update scale inside the accumulation)
    ts = three(SAETrainer, "sae", {"asr": asr_tree, "sae": {"params": sae_params,
                                                            "bn_state": sae_bn}},
               lambda t: [t.optim])
    run(f"SAE (Adam) {ACCUM} x B={AUX_MICRO_B} T={x.shape[1]}", ts, lambda t: [t.optim],
        lambda ts, sl: anchored_losses(
            torch, f"SAE micro-batch {sl.start // AUX_MICRO_B}", ts,
            lambda t, dev: t.recon_loss(x[sl].to(dev).to(dt(t, "sae")), x_lens[sl].to(dev),
                                        True)[0], pooled=("sae.encoder.",)))
    # ADV: the D-step (the ReLU witness of relu_flip_sweep), then the G-step, per micro-batch
    ya, yla, _, _ = text_batch(torch, rng, B, 0.0)
    ts = three(ADVTrainer, "adv", {"asr": asr_tree, "tae": tae_tree, "adv": disc_tree},
               lambda t: [t.D_optim, t.G_optim])
    before, excused = snapshot(torch, ts, lambda t: [t.D_optim, t.G_optim]), set()
    for i, sl in enumerate(parts):
        excused |= relu_flip_sweep(torch, f"ADV D micro-batch {i}", ts,
                                   lambda r: (x[sl], x_lens[sl], ya[sl], yla[sl]), (i,))
        for t, dev in zip(ts, (DEVICE, "cpu", "cpu")):
            t.zero_grad()
            rl, fl, _, _ = t.d_losses(x[sl].to(dev).to(dt(t, "disc")), x_lens[sl].to(dev),
                                      ya[sl].to(dev), yla[sl].to(dev), t.label_smoothing)
            (rl + fl).backward()
            t.D_optim.step()
        excused |= set(anchored_losses(
            torch, f"ADV G micro-batch {i}", ts,
            lambda t, dev: t.g_loss(x[sl].to(dev).to(dt(t, "disc")), x_lens[sl].to(dev))))
        for t in ts:
            t.G_optim.step()
    update_errors(torch, f"ADV D + G (Adadelta) {ACCUM} x B={AUX_MICRO_B}", ts,
                  lambda t: [t.D_optim, t.G_optim], before, excused)
    # the char-LM on the corpus of phase 5
    lmc = c["char_lm"]
    lmc.update(train_index=os.path.join(tmp, "lm_corpus.txt"))
    lm_cfg = charlm.CharLMConfig.from_dict(lmc["mdl"])
    lm_tree = convert.init_charlm_numpy(SEED + 16, lm_cfg)
    ts = []
    for tag, dev in (("card", DEVICE), ("cpu", "cpu"), ("f64", "cpu")):
        paras = make_paras(name=f"acc_lm_{tag}", logdir=os.path.join(tmp, "runs"),
                           ckpdir=os.path.join(tmp, "result"), seed=SEED, verbose=False)
        save_pytree(os.path.join(tmp, "result", f"acc_lm_{tag}", "char_lm.npz"), lm_tree)
        t = CHARLMTrainer(c, paras, device=dev)
        t.load_data()
        t.set_model()
        ts.append(t)
    ts[2].lm.double()
    float64_optim(ts[2].optim)
    L = lmc["chunk_size"]
    ids = torch.from_numpy(rng.integers(3, lm_cfg.vocab_size, size=(ACCUM * LM_MICRO_B, L)))
    gen = torch.Generator().manual_seed(SEED)
    draws = [las.draw_scheduled_sampling(L, LM_MICRO_B, lm_cfg.tf_rate, lm_cfg, gen, device="cpu")
             for _ in range(ACCUM)]
    lm_parts = [slice(i * LM_MICRO_B, (i + 1) * LM_MICRO_B) for i in range(ACCUM)]
    before = snapshot(torch, ts, lambda t: [t.optim])
    for i, sl in enumerate(lm_parts):
        tf_draws, gumbel = draws[i]
        anchored_losses(torch, f"char-LM micro-batch {i}", ts,
                        lambda t, dev: t.loss_of(ids[sl].to(dev), tf_draws.to(dev), gumbel.to(
                            dev).to(t.lm.out.weight.dtype))[0])
        for t in ts:
            t.optim.step()
    update_errors(torch, f"char-LM (Adam) {ACCUM} x B={LM_MICRO_B} L={L}", ts,
                  lambda t: [t.optim], before)


def check_import(torch, config, asr_path, lm_path, sigs, tmp):
    """``cli.import_ckpt --export`` of the trained ASR and LM to
    reference-keyed ``.cpt`` files, and the import back: every array equal
    bit for bit; the imported pair behind the server under the default
    decode (beam 3 + LM 0.5): replies equal the direct batch, whose
    transcripts equal the original pair's.  Returns {path: launches}."""
    import numpy as np

    from ss_asr_tpu_torch.api import Transcriber
    from ss_asr_tpu_torch.cli import import_ckpt
    from ss_asr_tpu_torch.utils import checkpoint as ckpt

    src, cpt, back = (os.path.join(tmp, d) for d in ("import_src", "import_cpt", "import_back"))
    os.makedirs(src)
    shutil.copyfile(asr_path, os.path.join(src, "asr.npz"))
    shutil.copyfile(lm_path, os.path.join(src, "char_lm.npz"))
    rc1, out1 = run_main(import_ckpt.main, [src, cpt, "--export"])
    rc2, out2 = run_main(import_ckpt.main, [cpt, back])
    n_leaves, unequal = 0, []
    for name in ("asr.npz", "char_lm.npz"):
        a = ckpt._flatten(ckpt.load_pytree(os.path.join(src, name)))
        b = ckpt._flatten(ckpt.load_pytree(os.path.join(back, name)))
        n_leaves += len(a)
        unequal += [f"{name}:{k}" for k in a if not (k in b and a[k].dtype == b[k].dtype
                                                       and np.array_equal(a[k], b[k]))]
        unequal += [f"{name}:{k} (extra)" for k in b if k not in a]
    print(f"cli.import_ckpt: --export {sorted(os.listdir(cpt))} (exit {rc1}), imported back "
          f"{sorted(os.listdir(back))} (exit {rc2}): {n_leaves} leaves, bit-equal "
          f"{not unequal}", flush=True)
    if rc1 or rc2 or unequal:
        fail(f"cli.import_ckpt: exits {rc1} / {rc2}, unequal {unequal[:5]}")
    orig = Transcriber.from_checkpoint(os.path.join(src, "asr.npz"), config,
                                       lm_path=os.path.join(src, "char_lm.npz"), device=DEVICE,
                                       sr=PRE_SR)
    imp = Transcriber.from_checkpoint(os.path.join(back, "asr.npz"), config,
                                      lm_path=os.path.join(back, "char_lm.npz"), device=DEVICE,
                                      sr=PRE_SR)
    launches = serve_phase(torch, "serve default imported", imp, sigs,
                           ("fbank", "lstm_fwd", "beam_decode_lm"), sr=PRE_SR, min_chars=3)
    want, got = orig.transcribe_signal_batch(sigs, sr=PRE_SR), imp.transcribe_signal_batch(
        sigs, sr=PRE_SR)
    print(f"the imported pair's transcripts equal the original pair's: {got == want} "
          f"({got[:3]})", flush=True)
    if got != want:
        fail(f"the imported pair transcribes {got}, the original {want}")
    return launches


def check_options(torch, rng, config, asr_tree, asr_path, lm_path, sigs, tmp):
    """Phase 11: SpecAugment, gradient accumulation at the flagship, a
    schedule, ``cli.train`` with the options and a resume in the middle of
    an accumulation, accumulated updates of the other trainers, and
    ``import_ckpt`` of the trained pair.  Returns {path: launches}."""
    t0 = time.perf_counter()
    check_augment(torch, rng)
    launches = check_accumulation(torch, rng, config, asr_tree, tmp)
    check_schedule(torch)
    check_cli_options(rng, config, tmp)
    check_aux_accumulation(torch, rng, config, asr_tree, tmp)
    launches.update(check_import(torch, config, asr_path, lm_path, sigs, tmp))
    print(f"phase 11 (options, import_ckpt): {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ----------------------------------------------------------------------
# phase 12: data parallelism and mesh serving

DP_RANKS = 2  # two ranks share the one card under gloo (NCCL refuses two ranks on a card)
DP_STEPS = 3  # DP steps held against one process and float64, the ranks bit-equal after each
DP_TIMED = 5  # further steps timed on each side (the median is reported)
DP_RANK_TIMEOUT = 180  # s: a rank still running then is killed and the phase fails
DP_CLI_UTTS = 31  # odd: strided shards of 16 and 15 rows pack 2 and 1 batches of DP_CLI_B
DP_CLI_B = 8
DP_CLI_EPOCHS = 3
MESH_TIMED = 5  # direct batches timed on each side of the mesh comparison


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (for a process group's rendezvous)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_entry(fn, rank, world, port, out_dir, device, args):
    """One rank started by ``run_ranks``, in a process of its own:
    torchrun's environment, one torch thread, the process group of
    ``parallel.mesh.init_process_group(device)``; runs ``fn(rank, world,
    this rank's device, *args)`` and pickles what it returns to
    ``<out_dir>/rank<r>.pkl`` (or its traceback to ``rank<r>.err``)."""
    import pickle
    import traceback

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        from ss_asr_tpu_torch.parallel import mesh as pmesh

        out = fn(rank, world, pmesh.init_process_group(device), *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world, out_dir, *args, device=None, timeout=DP_RANK_TIMEOUT) -> list:
    """``fn(rank, world, device, *args)`` on ``world`` ranks (``rank_entry``)
    started by ``spawn`` on ``device`` (default DEVICE: every rank on the
    card, under gloo), all joined within ``timeout`` s; a rank still running
    then is killed, and a rank that failed or hung raises -> each rank's
    result, in rank order."""
    import multiprocessing as mp
    import pickle

    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_entry, args=(fn, r, world, port, out_dir, device or DEVICE,
                                                   args), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(30)
    errs = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errs.append(f"rank {r}: {f.read()[-3000:]}")
    if hung or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"ranks {hung} still running after {timeout} s (killed); exit codes "
                           f"{[p.exitcode for p in procs]}\n" + "\n".join(errs))
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def rank_steps(rank, world, dev, config, tmp, name, wave, n, y):
    """One rank of phase 12 (a) or 13 (a): an ASRTrainer on its data
    index's rows of the global batch (the frontend on the card from the
    waveforms, then the step), DP_STEPS steps, a digest of the model's
    (under tensor parallelism: the gathered) parameters after each and the
    launches of those steps; then DP_TIMED timed steps."""
    import hashlib

    import torch
    import torch.distributed as dist

    from ss_asr_tpu_torch.ops.frontend import log_mel_fbank_batch
    from ss_asr_tpu_torch.train.asr_trainer import ASRTrainer
    from ss_asr_tpu_torch.train.solver import make_paras

    t = ASRTrainer(config, make_paras(name=name, logdir=os.path.join(tmp, "runs"),
                                      ckpdir=os.path.join(tmp, "result"), seed=SEED,
                                      verbose=False), device=str(dev))
    t.set_model()
    b = wave.shape[0] // t.n_data
    rows = slice(t.data_index * b, (t.data_index + 1) * b)
    w, nn, yy = (torch.from_numpy(a[rows]).to(dev) for a in (wave, n, y))
    named = dict(t.model.named_parameters())

    def step():
        with torch.no_grad():
            fb, fl = log_mel_fbank_batch(w, nn, SR)
        return t.step(fb, fl, yy)[0]

    before = {k: named[k].detach().cpu().double() for k in t.optim.params}
    zero_launches()
    losses, digests = [], []
    for _ in range(DP_STEPS):
        losses.append(float(step()))
        digests.append(hashlib.sha256(b"".join(
            p.detach().cpu().numpy().tobytes() for p in t.model.parameters())).hexdigest())
    launches = read_launches()
    update = ({k: (named[k].detach().cpu().double() - before[k]).numpy() for k in t.optim.params}
              if rank == 0 else None)
    comm = dict(t.tp.bytes) if t.tp is not None else None
    times = []
    for _ in range(DP_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"losses": losses, "digests": digests, "launches": launches, "update": update,
            "times": times, "device": str(dev), "backend": dist.get_backend(),
            "host_shard": t.host_shard, "mesh": str(t.mesh), "bytes": comm,
            "shards": len(t.optim.shards)}


def one_process_reference(torch, c, asr_tree, tmp, wave, n, y):
    """One process on the whole batch, on the card, on the CPU and in
    float64 (the plain versions), DP_STEPS steps each, then DP_TIMED timed
    card steps: what phases 12 (a) and 13 (a) hold their ranks against.
    Returns {"losses": [card, cpu, f64] lists, "updates": {name: (card,
    cpu, f64) float64 host tensors}, "times": card ms}."""
    from ss_asr_tpu_torch.ops.frontend import log_mel_fbank_batch

    with torch.no_grad():
        x, x_lens = log_mel_fbank_batch(wave, n, SR)
    ts = [trainer(c, tmp, f"one_process_{tag}", asr_tree, dev)
          for tag, dev in (("card", DEVICE), ("cpu", "cpu"), ("f64", "cpu"))]
    ts[2].model.double()
    float64_optim(ts[2].optim)
    before = snapshot(torch, ts, lambda t: [t.optim])

    def card_step():
        with torch.no_grad():
            fb, fl = log_mel_fbank_batch(wave, n, SR)
        return ts[0].step(fb, fl, y)[0]

    losses = [[float(card_step()) for _ in range(DP_STEPS)]]
    for t in ts[1:]:
        dt = next(t.model.parameters()).dtype
        losses.append([float(t.step(x.cpu().to(dt), x_lens.cpu(), y.cpu())[0])
                       for _ in range(DP_STEPS)])
    updates = {name: tuple(t.optim.params[name].detach().cpu().double() - b[name]
                           for t, b in zip(ts, before))
               for name in sorted(ts[0].optim.mask)}
    times = []
    for _ in range(DP_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        card_step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"losses": losses, "updates": updates, "times": times, "T": x.shape[1]}


def against_reference(torch, tag, r0, ref):
    """Rank 0's losses and updates against the one-process reference by the
    anchored rule (error against float64 at most ANCHOR_RATIO times the CPU
    float32 run's, or below STEP_FLOOR); fails naming each miss.  Returns
    (the worst (rank, one process on the card, CPU) errors, its name)."""
    worst, bad = (0.0, 0.0, 0.0, ""), []
    card, cpu, f64 = ref["losses"]
    rows = [(f"loss {s + 1}", torch.tensor(r0["losses"][s]), torch.tensor(card[s]),
             torch.tensor(cpu[s]), torch.tensor(f64[s])) for s in range(DP_STEPS)]
    rows += [(name, torch.from_numpy(r0["update"][name]), *ref["updates"][name])
             for name in sorted(ref["updates"])]
    for name, got, one, c, f in rows:
        k, s1, cc = (rel_l2(torch, v.double(), f.double()) for v in (got, one, c))
        worst = max(worst, (k, s1, cc, name))
        if not k <= max(ANCHOR_RATIO * cc, STEP_FLOOR):
            bad.append(f"{name} ({tag} {k:.3e}, one process on the card {s1:.3e}, CPU {cc:.3e})")
    if bad:
        fail(f"{tag} step: error against float64 above {ANCHOR_RATIO} x the CPU float32's and "
             f"{STEP_FLOOR}: {bad}")
    return worst, len(rows) - DP_STEPS


def check_dp_step(torch, rng, config, asr_tree, tmp):
    """Phase 12 (a): the flagship ASR step over DP_RANKS ranks on the one
    card under gloo (global batch TRAIN_B = 2 x 16, tf 0.9), DP_STEPS steps:
    the ranks' parameters bit-equal after every step; the losses and the
    parameters' updates held against one process on the joined batch, by
    the anchored rule against a float64 run of the plain versions (the
    ranks' error at most ANCHOR_RATIO times the CPU float32 run's, or below
    STEP_FLOOR); each rank's launches (K11, K2, K3, K9, K10 on their
    cluster routes); then the step's wall beside the single process's.
    Returns ({path: launches}, the batch and config, the one-process
    reference), which phase 13 (a) reuses."""
    from ss_asr_tpu_torch.utils.checkpoint import save_pytree

    wave, n, y = train_batch(torch, rng)
    c = copy.deepcopy(config)
    c["asr"]["mdl"]["tf_rate"] = 0.9
    save_pytree(os.path.join(tmp, "result", "dp_ranks", "asr.npz"), asr_tree)
    t0 = time.perf_counter()
    ranks = run_ranks(rank_steps, DP_RANKS, os.path.join(tmp, "dp_step_ranks"),
                      {**c, "parallel": {"n_data": "auto"}}, tmp, "dp_ranks",
                      *(a.cpu().numpy() for a in (wave, n, y)))
    secs = time.perf_counter() - t0
    r0, r1 = ranks
    print(f"DP step: {DP_RANKS} ranks on {r0['device']} / {r1['device']} ({r0['backend']}), "
          f"shards {r0['host_shard']} / {r1['host_shard']}, mesh {r0['mesh']}; ranks done in "
          f"{secs:.1f} s (start-up included)", flush=True)
    for s, (a, b) in enumerate(zip(r0["digests"], r1["digests"])):
        if a != b:
            fail(f"DP step: the ranks' parameters differ after step {s + 1}")
    if r0["losses"] != r1["losses"]:
        fail(f"DP step: the ranks' losses differ: {r0['losses']} / {r1['losses']}")
    launches = {k: r0["launches"][k] + r1["launches"][k] for k in r0["launches"]}
    for name in ("fbank", "lstm_fwd", "lstm_bwd", "spell_fwd", "spell_bwd"):
        if r0["launches"][name] < DP_STEPS or r1["launches"][name] < DP_STEPS:
            fail(f"DP step: launched {name} {r0['launches'][name]} / {r1['launches'][name]} "
                 f"times in {DP_STEPS} steps")
    require_cluster_route("DP step", launches)

    # one process on the joined batch: on the card, on the CPU and in float64
    ref = one_process_reference(torch, c, asr_tree, tmp, wave, n, y)
    worst, n_updates = against_reference(torch, "DP", r0, ref)
    losses = ref["losses"]
    print(f"DP step B={TRAIN_B} = {DP_RANKS} x {TRAIN_B // DP_RANKS} T={ref['T']} L={TRAIN_L} "
          f"tf 0.9, {DP_STEPS} steps: losses DP {[f'{v:.6f}' for v in r0['losses']]}, one "
          f"process {[f'{v:.6f}' for v in losses[0]]}, float64 "
          f"{[f'{v:.6f}' for v in losses[2]]}; the losses and the {n_updates} "
          f"updates against float64: worst DP rel L2 {worst[0]:.3e} (one process on the card "
          f"{worst[1]:.3e}, CPU float32 {worst[2]:.3e}, {worst[3]}); ranks bit-equal after "
          f"every step", flush=True)
    times = ref["times"]
    dp_ms, one_ms = statistics.median(r0["times"]), statistics.median(times)
    print(f"DP step wall (CUDA events, median of {DP_TIMED}): {DP_RANKS} ranks sharing the card "
          f"{dp_ms:.3f} ms (rank 1 {statistics.median(r1['times']):.3f}; min "
          f"{min(r0['times']):.3f}, max {max(r0['times']):.3f}) against one process on the "
          f"joined batch {one_ms:.3f} ms (min {min(times):.3f}, max {max(times):.3f}): the gloo "
          f"all-reduce and two processes on one card, not a data-parallel gain; launches per "
          f"rank and step {({k: v // DP_STEPS for k, v in r0['launches'].items() if v})}",
          flush=True)
    return {"dp step": launches}, (c, wave, n, y), ref


def check_dp_cli(config, split, tmp):
    """Phase 12 (b): ``cli.train ASRTrainer`` through ``python -m
    torch.distributed.run --nproc-per-node DP_RANKS`` with ``parallel:
    {distributed: true, n_data: auto}`` (``torchrun_cli``).  Returns the
    ckpdir."""
    return torchrun_cli(config, split, tmp, "dp", {"n_data": "auto"}, DP_RANKS)


def torchrun_cli(config, split, tmp, tag, parallel, world):
    """``cli.train ASRTrainer`` through ``python -m torch.distributed.run
    --nproc-per-node world`` with ``parallel: {distributed: true,
    **parallel}`` on DP_CLI_UTTS of the tone corpus's train split (odd: the
    step cap trims one data index's second batch), in one ckpdir: every
    rank logs the same losses at the same steps, rank 0 alone writes the
    checkpoints (saved every step, a barrier after each), and a second
    invocation resumes on every rank at the saved step.  Returns the
    ckpdir."""
    import yaml

    from ss_asr_tpu_torch.data.index import load_index, save_index

    d = os.path.join(tmp, f"{tag}_cli")
    os.makedirs(d, exist_ok=True)
    idx = os.path.join(d, "train.tsv")
    save_index(load_index(split[0])[:DP_CLI_UTTS], idx)
    ck = os.path.join(d, "result", tag)
    name = f"torchrun --nproc-per-node {world} cli.train ({parallel})"

    def run(n_epochs):
        c = train_config(config, (idx, split[1]), n_epochs)
        c["asr"].update(train_batch_size=DP_CLI_B, valid_batch_size=DP_CLI_B, save_step=1)
        c["parallel"] = {"distributed": True, **parallel}
        path = os.path.join(d, f"{tag}_{n_epochs}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(c, f)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(world),
             "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
             "-m", "ss_asr_tpu_torch.cli.train", "ASRTrainer", tag, path,
             os.path.join(d, "runs"), os.path.join(d, "result"), "--seed", str(SEED),
             "--verbose", "0", "--device", DEVICE],
            cwd=HERE, env={**os.environ, "PYTHONPATH": HERE}, capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            fail(f"{name} exited {proc.returncode}: {proc.stderr[-3000:]}")
        logs = []
        for sub in [""] + [f"rank{r}" for r in range(1, world)]:
            with open(os.path.join(d, "runs", tag, "asr", sub, "metrics.jsonl")) as f:
                logs.append([(r["step"], r["value"]) for r in map(json.loads, f)
                             if r["key"] == "asr_train_loss"])
        with open(os.path.join(ck, "tracker.json")) as f:
            step = json.load(f)["asr"]["step"]
        return time.perf_counter() - t0, logs, step

    secs, logs, step = run(DP_CLI_EPOCHS)
    files = sorted(os.listdir(ck))
    print(f"{name}: {DP_CLI_UTTS} tone utterances, batch {DP_CLI_B} a data index, "
          f"{DP_CLI_EPOCHS} epochs in {secs:.1f} s (processes included); rank 0 steps "
          f"{[s for s, _ in logs[0]]}, losses {[f'{v:.4f}' for _, v in logs[0]]}, the other "
          f"ranks' logs equal: {all(lg == logs[0] for lg in logs)}; tracker step {step}; "
          f"ckpdir {files}", flush=True)
    if not (all(lg == logs[0] for lg in logs) and [s for s, _ in logs[0]] ==
            list(range(DP_CLI_EPOCHS)) and step == DP_CLI_EPOCHS):
        fail(f"{name}: the ranks' logs {logs} or the tracker step {step} are not "
             f"{DP_CLI_EPOCHS} equal steps (one a data index and epoch, the cap trimming the "
             "other)")
    if not {"asr.npz", "asr_opt.npz", "tracker.json"} <= set(files):
        fail(f"{name}: the ckpdir holds {files}")
    secs, logs, step = run(1)
    resumed = [[s for s, _ in lg[DP_CLI_EPOCHS:]] for lg in logs]
    print(f"{name} resumed: steps {resumed} (a list a rank) in {secs:.1f} s; tracker step "
          f"{step}", flush=True)
    if not (all(r == [DP_CLI_EPOCHS] for r in resumed) and all(lg == logs[0] for lg in logs)
            and step == DP_CLI_EPOCHS + 1):
        fail(f"{name} did not resume on every rank at step {DP_CLI_EPOCHS}: {resumed}, tracker "
             f"step {step}")
    return ck


def recording(t):
    """Record each ``(x, lens, model, lm, tokens)`` decode call of Transcriber ``t``."""
    calls, real = [], t._decode

    def decode(x, lens, model, lm):
        toks = real(x, lens, model, lm)
        calls.append((x, lens, model, lm, toks))
        return toks

    t._decode = decode
    return calls


def mesh_matches_single(torch, tag, single, meshed, signals):
    """The mesh Transcriber's transcripts against the single device's on
    the same signals.  Equal, or else held by the near-tie rule at the
    token level: a row may diverge only where the single device's path,
    replayed through the plain step, has a gap below NEAR_TIE (greedy:
    the top two scores; beam: neighbours among the K + 1 best candidates),
    at most MAX_NEAR_TIE_ROWS rows.  Returns the near-tie rows."""
    import numpy as np

    from ss_asr_tpu_torch.models import las
    from ss_asr_tpu_torch.ops.kernels import beam as kbeam

    calls = [recording(t) for t in (single, meshed)]
    want = single.transcribe_signal_batch(signals, sr=SR)
    got = meshed.transcribe_signal_batch(signals, sr=SR)
    for t in (single, meshed):
        del t._decode
    if len(calls[1]) != len(meshed._w[2]):
        fail(f"{tag}: {len(calls[1])} shard decodes over a mesh of {len(meshed._w[2])}")
    if got == want:
        print(f"{tag}: the mesh's {len(got)} transcripts ({len(calls[1])} shards) equal the "
              f"single device's", flush=True)
        return 0
    (x, lens, model, lm, toks), = calls[0]
    lm, w = single._fused_lm(lm)
    with torch.inference_mode():
        enc_h, enc_lens = las.listener_apply(model.encoder, x, lens)
        comp_h = las.attention_precompute(model.attention, enc_h)
        if single.beam_size == 1:
            pad = lambda a: np.pad(a, ((0, 0), (0, MAX_STEPS - a.shape[1])))  # noqa: E731
            want_t = pad(np.asarray(toks))
            got_t = np.concatenate([pad(np.asarray(c[4])) for c in calls[1]])
            gaps = plain_gaps(torch, model, enc_h, comp_h, enc_lens,
                              torch.from_numpy(want_t).to(enc_h.device), lm, w)
        else:
            K = single.beam_size

            def frontier(x_, lens_, m_, l_):
                e, el = las.listener_apply(m_.encoder, x_, lens_)
                return kbeam.beam_device(m_, e, las.attention_precompute(m_.attention, e), el, K,
                                         MAX_STEPS, l_ if w else None, w)

            want_f = frontier(x, lens, model, lm)
            shards = [frontier(c[0], c[1], c[2], c[3]) for c in calls[1]]
            got_f = [torch.cat([s[i] for s in shards], 1 if i < 2 else 0) for i in range(5)]
            cands = replay_frontier(torch, model, lm, w, enc_h, comp_h, enc_lens, *want_f[:2])[0]
            gaps = frontier_gaps(torch, cands, K, MAX_STEPS)

            def steps(f):  # [B, T, 2, K]: each step's tokens and parents
                return np.stack([f[0].cpu().numpy(), f[1].cpu().numpy()], -2).transpose(1, 0, 2, 3)

            want_t, got_t = steps(want_f), steps(got_f)
    near, _, _ = compare_tokens(tag, got_t, want_t, gaps)
    return near


def check_mesh_serving(torch, config, asr_tree, lm_path, new_asr_tree, sigs, tmp):
    """Phase 12 (c): ``Transcriber(mesh=make_mesh(devices=[card, card]))``
    beside the single-device Transcriber on the phase-6 signals, greedy,
    greedy + LM and the default decode (beam 3 + LM 0.5): the mesh's
    transcripts equal the single device's (``mesh_matches_single``), each
    shard decoding through the kernels (counted); then ``serve_http`` over
    the mesh Transcriber (default decode): every reply 200 and equal to the
    mesh's direct batch, ``?detail=1&nbest=3`` equal to its direct call, and
    one ``/reload`` after which a reply equals a mesh Transcriber loaded
    from the new checkpoint.  Returns {path: launches}."""
    from ss_asr_tpu_torch.api import Transcriber
    from ss_asr_tpu_torch.data.audio import read_wav
    from ss_asr_tpu_torch.ops.frontend import compute_fbank
    from ss_asr_tpu_torch.parallel.mesh import make_mesh
    from ss_asr_tpu_torch.utils.checkpoint import save_pytree

    mesh = make_mesh(devices=[DEVICE] * DP_RANKS)
    asr_path = os.path.join(tmp, "mesh_asr.npz")
    new_path = os.path.join(tmp, "mesh_new_asr.npz")
    save_pytree(asr_path, asr_tree)
    save_pytree(new_path, new_asr_tree)
    sizes = {"asr": {"mdl": config["asr"]["mdl"]}, "char_lm": config["char_lm"]}

    def pair(lm, path=asr_path, **kw):
        """(single-device, mesh) Transcribers of one checkpoint."""
        cfg = kw.pop("config", sizes)
        return [Transcriber.from_checkpoint(path, cfg, lm_path=lm, device=DEVICE,
                                            max_steps=MAX_STEPS, sr=SR, **kw, **extra)
                for extra in ({}, {"mesh": mesh})]

    bodies = [wav_bytes(s, SR) for s in sigs]
    signals = [read_wav(io.BytesIO(b))[1] for b in bodies]
    launches, near = {}, 0
    for tag, lm, kw, kernel in (("greedy", None, {"beam_size": 1}, "greedy_decode"),
                                ("greedy + LM", lm_path, {"beam_size": 1, "lm_weight": 0.5},
                                 "greedy_decode_lm"),
                                ("default", lm_path, {"config": config}, "beam_decode_lm")):
        single, meshed = pair(lm, **kw)
        if meshed.mesh is not mesh or len(meshed._w[2]) != DP_RANKS:
            fail(f"mesh {tag}: the Transcriber holds {len(meshed._w[2])} replicas")
        meshed.transcribe_signal_batch(signals[:1], sr=SR)  # warm-up
        zero_launches()
        meshed.transcribe_signal_batch(signals, sr=SR)
        launches[f"mesh {tag}"] = ls = read_launches()
        for name in ("fbank", "lstm_fwd", kernel):
            if ls[name] < DP_RANKS:
                fail(f"mesh {tag}: launched {name} {ls[name]} times over {DP_RANKS} shards")
        require_cluster_route(f"mesh {tag}", ls)
        near += mesh_matches_single(torch, f"mesh {tag}", single, meshed, signals)
        walls = {}
        for who, t in (("single device", single), (f"mesh of {DP_RANKS}", meshed)):
            times = []
            for _ in range(MESH_TIMED):
                t0 = time.perf_counter()
                t.transcribe_signal_batch(signals, sr=SR)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            walls[who] = f"{statistics.median(times):.3f} ms (min {min(times):.3f})"
        print(f"mesh {tag}: a batch of {len(signals)} signals, wall median of {MESH_TIMED}: "
              f"{walls}", flush=True)
    # the server over the mesh Transcriber of the default decode
    y = signals[1]
    want_detail = meshed.transcribe_fbank_detailed(compute_fbank(y, SR, device=DEVICE),
                                                   n_best=3)[0]
    want_fresh = pair(lm_path, path=new_path, config=config)[1].transcribe_signal(y, SR)

    def detail(post):
        code, obj = post("/transcribe?detail=1&nbest=3", bodies[1])
        if not (code == 200 and [h["text"] for h in obj["hypotheses"]]
                == [h.text for h in want_detail]):
            fail(f"serve mesh: ?detail=1&nbest=3: {code} {obj}, the direct call "
                 f"{[h.text for h in want_detail]}")
        print(f"serve mesh: ?detail=1&nbest=3 200, {len(want_detail)} hypotheses equal the mesh's "
              "direct call", flush=True)

    def reload(post):
        shutil.copyfile(new_path, asr_path)
        code, obj = post("/reload")
        if code != 200:
            fail(f"serve mesh: /reload {code} {obj}")
        code, obj = post("/transcribe", bodies[1])
        if (code, obj) != (200, {"text": want_fresh}):
            fail(f"serve mesh: /transcribe after /reload {code} {obj} != {want_fresh!r}")
        if any(m is not meshed._w[0] for m, _ in meshed._w[2]):
            fail("serve mesh: /reload left a mesh device on the old weights")
        print("serve mesh: /reload 200; every mesh device holds the new pair and the next reply "
              "equals a mesh Transcriber loaded from the new checkpoint", flush=True)

    dec = ("fbank", "lstm_fwd", "beam_decode_lm")
    launches.update(serve_phase(torch, "serve mesh", meshed, sigs, dec, sr=SR,
                                reload_paths={"asr": asr_path, "lm": lm_path},
                                routes=[("?detail", detail, dec + ("spell_fwd",)),
                                        ("/reload", reload, dec)]))
    print(f"mesh serving: near-tie rows {near} in all", flush=True)
    return launches


def check_data_parallel(torch, rng, config, asr_tree, lm_path, new_asr_tree, sigs, split, tmp):
    """Phase 12: the DP step over two ranks on the card, ``cli.train`` under
    torchrun, mesh serving.  Returns ({path: launches}, and for phase 13:
    the DP step's batch, its one-process reference, the DP run's ckpdir)."""
    t0 = time.perf_counter()
    launches, batch, ref = check_dp_step(torch, rng, config, asr_tree, tmp)
    dp_ck = check_dp_cli(config, split, tmp)
    launches.update(check_mesh_serving(torch, config, asr_tree, lm_path, new_asr_tree, sigs, tmp))
    print(f"phase 12 (data parallelism, mesh serving): {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches, batch, ref, dp_ck


# ----------------------------------------------------------------------
# phase 13: tensor parallelism

TP_STEP_MESH = (1, 2)  # (a): one model group of two ranks, sharing the card under gloo
TP_CLI_MESH = (2, 2)  # (b): torchrun --nproc-per-node 4
TP_PER_STEP = {"fbank": 1, "lstm_fwd": 4, "lstm_bwd": 4, "spell_fwd": 1, "spell_bwd": 1}
TP_CKPT_TOL = 1e-5  # (b)'s checkpoint against phase 12 (b)'s: relative L2 a leaf ...
TP_CKPT_ATOL = 1e-7  # ... or every element within this (a leaf of rounding noise)


def column_parallel_bytes(cfg, B, T, gathered) -> int:
    """The bytes a rank would hand to its collectives a step if the
    listener's input projections and ``psi`` ran column-parallel instead of
    on gathered weights (``gathered`` bytes a step now): their outputs
    all-gathered (gx [T_l, B, 8H] a layer, both directions; psi's [B, S,
    M]), their inputs' gradients all-reduced (layers 2-4 and psi: layer 1's
    fbank input takes none), and the other sharded weights gathered as now.
    float32."""
    H, S = cfg.encoder_state_size, T // 8
    gx = sum((T >> i) * B * 8 * H for i in range(4)) + B * S * cfg.mlp_out_size
    dx = sum((T >> i) * B * 4 * H for i in range(1, 4)) + B * S * cfg.enc_out_dim
    w_ih = 2 * 4 * H * (cfg.feature_dim + 3 * 4 * H) + cfg.enc_out_dim * cfg.mlp_out_size
    return int(4 * (gx + dx - w_ih) + gathered)


def check_tp_step(torch, config, asr_tree, tmp, batch, ref):
    """Phase 13 (a): the flagship ASR step (B = TRAIN_B, T = 512, L =
    TRAIN_L, tf 0.9, the frontend from the waveforms) over the TP_STEP_MESH
    ranks in processes of their own sharing the card under gloo, on phase
    12's batch: every rank's gathered parameters bit-equal after each of
    DP_STEPS steps; each rank's launches exactly TP_PER_STEP a step on the
    cluster routes; the losses and updates held against phase 12's one
    process on the same batch by the anchored rule; the step's wall (CUDA
    events, median of DP_TIMED) beside that process's, and the bytes each
    rank gathered and reduced a step beside what the column-parallel form
    would move.  Returns {path: launches}."""
    from ss_asr_tpu_torch.models.las import ASRConfig
    from ss_asr_tpu_torch.utils.checkpoint import save_pytree

    c, wave, n, y = batch
    D, M = TP_STEP_MESH
    save_pytree(os.path.join(tmp, "result", "tp_ranks", "asr.npz"), asr_tree)
    t0 = time.perf_counter()
    ranks = run_ranks(rank_steps, D * M, os.path.join(tmp, "tp_step_ranks"),
                      {**c, "parallel": {"n_data": D, "n_model": M}}, tmp, "tp_ranks",
                      *(a.cpu().numpy() for a in (wave, n, y)))
    secs = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"TP step: {D * M} ranks on {[r['device'] for r in ranks]} ({r0['backend']}), mesh "
          f"{r0['mesh']}, {r0['shards']} of the optimizer's tensors sharded; ranks done in "
          f"{secs:.1f} s (start-up included)", flush=True)
    for r in ranks[1:]:
        if r["digests"] != r0["digests"] or r["losses"] != r0["losses"]:
            fail(f"TP step: the ranks' gathered parameters or losses differ: "
                 f"{[q['losses'] for q in ranks]}")
    for rank, r in enumerate(ranks):
        got = {k: r["launches"][k] for k in TP_PER_STEP}
        if got != {k: v * DP_STEPS for k, v in TP_PER_STEP.items()}:
            fail(f"TP step: rank {rank} launched {got} in {DP_STEPS} steps, not "
                 f"{TP_PER_STEP} a step")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}
    require_cluster_route("TP step", launches)
    worst, n_updates = against_reference(torch, "TP", r0, ref)
    losses = ref["losses"]
    print(f"TP step B={TRAIN_B} T={ref['T']} L={TRAIN_L} tf 0.9 at (data, model) = {D} x {M}, "
          f"{DP_STEPS} steps: losses TP {[f'{v:.6f}' for v in r0['losses']]}, one process "
          f"{[f'{v:.6f}' for v in losses[0]]}, float64 {[f'{v:.6f}' for v in losses[2]]}; the "
          f"losses and the {n_updates} updates against float64: worst TP rel L2 "
          f"{worst[0]:.3e} (one process on the card {worst[1]:.3e}, CPU float32 "
          f"{worst[2]:.3e}, {worst[3]}); the ranks' gathered parameters bit-equal after every "
          f"step", flush=True)
    cfg = ASRConfig.from_dict(c["asr"]["mdl"])
    gather, reduce = (r0["bytes"][k] / DP_STEPS for k in ("gather", "reduce"))
    tp_ms, one_ms = statistics.median(r0["times"]), statistics.median(ref["times"])
    print(f"TP step wall (CUDA events, median of {DP_TIMED}): {D * M} ranks sharing the card "
          f"{tp_ms:.3f} ms (rank 1 {statistics.median(ranks[1]['times']):.3f}; min "
          f"{min(r0['times']):.3f}, max {max(r0['times']):.3f}) against one process on the "
          f"batch {one_ms:.3f} ms (min {min(ref['times']):.3f}, max {max(ref['times']):.3f}); "
          f"bytes a rank handed to its all-reduces a step: gather {gather:.0f}, gradient "
          f"average {reduce:.0f} (the column-parallel projections would hand "
          f"{column_parallel_bytes(cfg, TRAIN_B, ref['T'], gather)}); launches per rank and step "
          f"{({k: v // DP_STEPS for k, v in r0['launches'].items() if v})}", flush=True)
    return {"tp step": launches}


def check_tp_cli(torch, config, split, held_sigs, dp_ck, tmp):
    """Phase 13 (b): ``cli.train ASRTrainer`` through ``torchrun
    --nproc-per-node 4`` at (data, model) = TP_CLI_MESH (``torchrun_cli``:
    every rank's losses equal, rank 0 alone writes, every rank resumes);
    the checkpoint's parameter and optimizer leaves full width and, since
    its data axis reads the rows and draws of phase 12 (b)'s two ranks,
    every leaf within TP_CKPT_TOL (relative L2; a leaf of rounding noise
    every element within TP_CKPT_ATOL) of the DP run's (``dp_ck``); the
    checkpoint served by a greedy ``Transcriber`` on the held-out signals
    of phase 10.  Returns {path: launches}."""
    import numpy as np

    from ss_asr_tpu_torch import convert
    from ss_asr_tpu_torch.api import Transcriber
    from ss_asr_tpu_torch.models.las import ASRConfig
    from ss_asr_tpu_torch.utils import checkpoint as ckpt

    D, M = TP_CLI_MESH
    ck = torchrun_cli(config, split, tmp, "tp", {"n_data": D, "n_model": M}, D * M)
    want = [a.shape for a in convert.tree_leaves(
        convert.init_asr_numpy(0, ASRConfig.from_dict(config["asr"]["mdl"])))]
    tp_leaves, dp_leaves = (convert.tree_leaves(ckpt.load_pytree(os.path.join(d, "asr.npz")))
                            for d in (ck, dp_ck))
    got = [np.shape(a) for a in tp_leaves]
    slots = [np.shape(a) for a in ckpt.load_opt_state(os.path.join(ck, "asr_opt.npz"))[3:]]
    if got != want or slots != want * 2:
        fail(f"TP cli.train: the checkpoint's leaves {got} / optimizer slots {slots} are not the "
             f"full-width {want}")
    errs = [(rel_l2(torch, torch.from_numpy(a).double(), torch.from_numpy(b).double()),
             float(np.abs(a.astype(np.float64) - b).max())) for a, b in zip(tp_leaves, dp_leaves)]
    worst = max(e for e, _ in errs)
    print(f"TP cli.train checkpoint against the DP run's (the same rows and draws): worst leaf "
          f"rel L2 {worst:.3e}", flush=True)
    if not all(e <= TP_CKPT_TOL or a <= TP_CKPT_ATOL for e, a in errs):
        fail(f"TP cli.train: the checkpoint differs from the DP run's: {errs}")
    t = Transcriber.from_checkpoint(os.path.join(ck, "asr.npz"), config, device=DEVICE,
                                    sr=PRE_SR, beam_size=1, max_steps=MAX_STEPS)
    t.transcribe_signal_batch(held_sigs[:1], sr=PRE_SR)  # warm-up
    zero_launches()
    texts = t.transcribe_signal_batch(held_sigs, sr=PRE_SR)
    launches = read_launches()
    print(f"TP cli.train checkpoint: {len(got)} leaves and {len(slots)} optimizer slots full "
          f"width; greedy Transcriber on {len(held_sigs)} held-out signals: "
          f"{[txt[:24] for txt in texts]}", flush=True)
    if len(texts) != len(held_sigs) or not all(isinstance(x, str) for x in texts):
        fail(f"TP checkpoint: the Transcriber gave {texts}")
    for k in ("fbank", "lstm_fwd", "greedy_decode"):
        if launches[k] < 1:
            fail(f"TP checkpoint decode: launched {k} {launches[k]} times")
    return {"tp decode": launches}


def check_tensor_parallel(torch, config, asr_tree, split, held_sigs, batch, ref, dp_ck, tmp):
    """Phase 13: the TP step over two ranks on the card, ``cli.train`` under
    torchrun at (2, 2).  Returns {path: launches}."""
    t0 = time.perf_counter()
    launches = check_tp_step(torch, config, asr_tree, tmp, batch, ref)
    launches.update(check_tp_cli(torch, config, split, held_sigs, dp_ck, tmp))
    print(f"phase 13 (tensor parallelism): {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def main() -> None:
    t_start = time.perf_counter()
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

    # phase 3: kernels against their plain versions, at the sizes of conf/default.yaml
    import yaml

    with open(os.path.join(HERE, "conf", "default.yaml")) as f:
        config = yaml.safe_load(f)
    cfg = las.ASRConfig.from_dict(config["asr"]["mdl"])
    lm_cfg = charlm.CharLMConfig.from_dict(config["char_lm"]["mdl"])
    asr_tree = convert.init_asr_numpy(SEED, cfg)
    lm_tree = convert.init_charlm_numpy(SEED + 1, lm_cfg)
    model = las.LAS(cfg)
    model.load_state_dict(convert.asr_state_from_params(asr_tree))
    model = model.to(DEVICE).eval()
    lm = charlm.CharLM(lm_cfg)
    lm.load_state_dict(convert.charlm_state_from_params(lm_tree))
    lm = lm.to(DEVICE).eval()
    rng = np.random.default_rng(SEED)
    results = {"lstm_fwd": check_lstm(torch, rng, asr_tree)}
    results.update(check_decode(torch, rng, model, lm))
    results.update(check_beam(torch, rng, model, lm))
    results.update(check_spell(torch, rng, model))
    results["lstm_bwd"] = check_lstm_bwd(torch, rng, asr_tree)
    results.update(check_spell_bwd(torch, rng, model))

    from ss_asr_tpu_torch.api import Transcriber

    sigs = synthetic_signals(rng)
    long_sig, stream_sig = long_signal(rng, LONG_SECONDS), long_signal(rng, 8.0)
    results.update(check_fbank(torch, rng, sigs, stream_sig))
    new_asr_tree = convert.init_asr_numpy(SEED + 2, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        # phase 4: data preparation; phase 5: the char-LM on the corpus's texts, which the
        # tester, its server and pseudolabel load (phase 10)
        idx, n = check_preprocess(torch, tmp)
        launches = {"preprocess": {**{k: 0 for k in read_launches()}, "fbank": n}}
        # its own stream, so that a phase added here moves no later phase's inputs (the ADV
        # D-step's draws that miss the anchored rule are held in relu_flip_sweep)
        lm_path = check_charlm(torch, np.random.default_rng(SEED + 9), config, idx, tmp)
        # phases 6-7 serve the random ASR with the seeded LM: next to the random ASR the
        # trained LM ends the decodes within a few steps
        paths = {"asr": os.path.join(tmp, "asr.npz"), "new_asr": os.path.join(tmp, "new_asr.npz"),
                 "lm": os.path.join(tmp, "seed_lm.npz")}
        save_pytree(paths["asr"], asr_tree)
        save_pytree(paths["lm"], lm_tree)

        sizes = {"asr": {"mdl": config["asr"]["mdl"]}, "char_lm": config["char_lm"]}

        def transcriber(lm_path=None, **kw):
            return Transcriber.from_checkpoint(paths["asr"], kw.pop("config", sizes),
                                               lm_path=lm_path, device=DEVICE,
                                               max_steps=MAX_STEPS, sr=SR, **kw)

        # phase 6: greedy serving, without and with the LM
        launches.update(serve_phase(torch, "serve", transcriber(beam_size=1), sigs,
                                    ("fbank", "lstm_fwd", "greedy_decode")))
        launches.update(serve_phase(torch, "serve+lm",
                                    transcriber(paths["lm"], beam_size=1, lm_weight=0.5), sigs,
                                    ("fbank", "lstm_fwd", "greedy_decode_lm")))
        # phase 7: serving under the default config's decode settings
        beam = transcriber(config=config)
        default = transcriber(paths["lm"], config=config)
        if (beam.beam_size, default.beam_size, default.lm_weight) != (3, 3, 0.5):
            fail(f"conf/default.yaml gave beam {beam.beam_size} / {default.beam_size}, "
                 f"LM weight {default.lm_weight}")
        launches.update(serve_phase(torch, "serve beam3", beam, sigs,
                                    ("fbank", "lstm_fwd", "beam_decode")))
        routes = default_routes(torch, default, config, paths, sigs[1], long_sig, stream_sig,
                                new_asr_tree)
        launches.update(serve_phase(
            torch, "serve default", default, sigs, ("fbank", "lstm_fwd", "beam_decode_lm"),
            reload_paths={"asr": paths["asr"], "lm": paths["lm"]}, routes=routes))
        # phase 8: the train step, then the training CLI
        launches["train"] = check_train_step(torch, rng, config, asr_tree, tmp)
        check_cli_train(rng, config, tmp)
        # phase 9: the auxiliary trainers, the Seed chain
        launches.update(check_aux_trainers(torch, rng, config, asr_tree, tmp))
        split, relay = check_cli_seed(config, idx, tmp)
        # phase 10: the tester, pseudo-labels and checkpoint averaging
        more, trained_asr, held_sigs = check_tester_and_tools(torch, config, split, relay,
                                                              lm_path, tmp)
        launches.update(more)
        # phase 11: the trainers' options and import_ckpt, on a stream of their own
        launches.update(check_options(torch, np.random.default_rng(SEED + 11), config, asr_tree,
                                      trained_asr, lm_path, held_sigs, tmp))
        # phase 12: data parallelism and mesh serving, on a stream of their own
        more, batch, ref, dp_ck = check_data_parallel(
            torch, np.random.default_rng(SEED + 12), config, asr_tree, paths["lm"], new_asr_tree,
            sigs, split, tmp)
        launches.update(more)
        # phase 13: tensor parallelism, on phase 12's batch, one-process reference and DP run
        launches.update(check_tensor_parallel(torch, config, asr_tree, split, held_sigs, batch,
                                              ref, dp_ck, tmp))
        del ref
    # each kernel's launches on the serving, training and test paths, each path counted on its own
    counts = {name: sum(ls[name] for ls in launches.values()) for name in results}
    cluster_launches = {name: sum(ls[counter] for ls in launches.values())
                        for name, counter in CLUSTER_COUNTERS.items()}

    replaces = {"lstm_fwd": ("lstm_fwd.cu", "ss_asr_tpu/ops/pallas/lstm.py:149"),
                "greedy_decode": ("greedy_decode.cu", "ss_asr_tpu/ops/pallas/decode.py:33"),
                "greedy_decode_lm": ("greedy_decode.cu", "ss_asr_tpu/ops/pallas/decode.py:281"),
                "beam_decode": ("beam_decode.cu", "ss_asr_tpu/ops/pallas/beam.py:74"),
                "beam_decode_lm": ("beam_decode.cu", "ss_asr_tpu/ops/pallas/beam.py:74"),
                "spell_fwd": ("spell_fwd.cu", "ss_asr_tpu/ops/pallas/spell.py:115"),
                "lstm_bwd": ("lstm_bwd.cu", "ss_asr_tpu/ops/pallas/lstm.py:217"),
                "spell_bwd": ("spell_bwd.cu", "ss_asr_tpu/ops/pallas/spell.py:208"),
                "fbank": ("frontend.cu", "ss_asr_tpu/ops/pallas/frontend.py:83")}
    # K2 with one direction is also the one-direction loop; K2's and K3's launches of
    # both directions also compute the fused BiLSTM forward and backward
    covers = {"lstm_fwd": ["ss_asr_tpu/ops/pallas/lstm.py:38", "ss_asr_tpu/ops/pallas/bilstm.py:33"],
              "lstm_bwd": ["ss_asr_tpu/ops/pallas/bilstm.py:75"]}
    kernels = [{"name": name, "route": "cuda", "source": f"ss_asr_tpu_torch/csrc/{src}",
                "replaces": rep, "launches": counts[name],
                "max_abs_err": results[name]["max_abs_err"], "ms": results[name]["ms"],
                "plain_ms": results[name]["plain_ms"], "bound_ms": results[name]["bound_ms"],
                "bound_by": results[name]["bound_by"], "library_ms": results[name]["library_ms"],
                **({"also_replaces": covers[name]} if name in covers else {}),
                **({"bound_f32_ms": results[name]["bound_f32_ms"]}
                   if "bound_f32_ms" in results[name] else {}),
                **({"k16": results[name]["k16"]} if "k16" in results[name] else {}),
                **({"cluster_launches": cluster_launches[name]} if name in cluster_launches
                   else {})}
               for name, (src, rep) in replaces.items()]
    print(f"smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
