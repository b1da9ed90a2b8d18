"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips.  On a machine
with one (which need not have JAX; the repository's conftest imports it, so
skip it there)::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py

The shapes are small and deliberately ragged (hidden sizes that are not a
multiple of the block, batches that are not a multiple of the row tile,
lengths 0 and 1), where ``chip_smoke.py`` checks the flagship shapes.
"""

import contextlib
import copy
import io
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import (FBANK_LIN_TOL, FBANK_LOG_TOL, anchored_losses, aux_trainer, compare_tokens,
                        eos_biased, fbank_errors, frontier_gaps, plain_gaps, replay_frontier)
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.api import Transcriber
from ss_asr_tpu_torch.models import charlm, las
from ss_asr_tpu_torch.ops import frontend
from ss_asr_tpu_torch.ops.kernels import beam as kbeam
from ss_asr_tpu_torch.ops.kernels import decode as kdec
from ss_asr_tpu_torch.ops.kernels import frontend as kfe
from ss_asr_tpu_torch.ops.kernels import lstm as klstm
from ss_asr_tpu_torch.ops.kernels import spell as kspell
from ss_asr_tpu_torch.vocab import EOS_ID, VOCAB_SIZE

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _models(cfg, lm_hidden, seed, device):
    model = las.LAS(cfg)
    model.load_state_dict(convert.asr_state_from_params(convert.init_asr_numpy(seed, cfg)))
    lcfg = charlm.CharLMConfig(hidden_size=lm_hidden)
    lm = charlm.CharLM(lcfg)
    lm.load_state_dict(convert.charlm_state_from_params(convert.init_charlm_numpy(seed + 1, lcfg)))
    return model.to(device).eval(), lm.to(device).eval()


@pytest.mark.parametrize("D,reverse", [(1, (False,)), (1, (True,)), (2, (False, True))])
@pytest.mark.parametrize("T,B,H", [(13, 5, 40), (1, 1, 8), (7, 17, 300)])
def test_lstm_fwd_matches_plain(cuda, D, reverse, T, B, H):
    rng = np.random.default_rng(T * B + H)
    gx = torch.from_numpy(rng.standard_normal((D, T, B, 4 * H)).astype(np.float32)).to(cuda)
    whh = torch.from_numpy((rng.standard_normal((D, H, 4 * H)) / np.sqrt(H)).astype(np.float32))
    whh = whh.to(cuda)
    lens = rng.integers(0, T + 1, size=B)
    lens[: min(B, 2)] = (0, 1)[: min(B, 2)]
    lengths = torch.from_numpy(lens.astype(np.int32)).to(cuda)
    before = klstm.LAUNCHES["lstm_fwd"]
    y, cs = klstm.lstm_fwd(gx, whh, lengths, reverse)
    torch.cuda.synchronize()
    assert klstm.LAUNCHES["lstm_fwd"] == before + 1
    for d in range(D):
        y_ref, cs_ref = klstm.lstm_seq_plain(gx[d], whh[d], lengths, reverse[d])
        torch.testing.assert_close(y[d], y_ref, atol=1e-5, rtol=0)
        torch.testing.assert_close(cs[d], cs_ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("sizes,lm_hidden", [
    (dict(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=5), 8),
    (dict(encoder_state_size=24, decoder_state_size=40, mlp_out_size=300, feature_dim=7), 36),
])
@pytest.mark.parametrize("use_lm", [False, True], ids=["greedy", "greedy+lm"])
def test_greedy_decode_matches_plain(cuda, sizes, lm_hidden, use_lm):
    cfg = las.ASRConfig(**sizes)
    model, lm = _models(cfg, lm_hidden, 3, cuda)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((6, 40, cfg.feature_dim)).astype(np.float32)).to(cuda)
    x_lens = torch.tensor([40, 33, 9, 3, 17, 40], dtype=torch.int32, device=cuda)
    lm_ = lm if use_lm else None
    with torch.inference_mode():
        enc_h, enc_lens = las.listener_apply(model.encoder, x, x_lens)
        comp_h = las.attention_precompute(model.attention, enc_h)
        got = kdec.greedy_decode(model, enc_h, comp_h, enc_lens, 30, lm_, 0.6)
        want = kdec.greedy_decode_plain(model, enc_h, comp_h, enc_lens, 30, lm_, 0.6)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_greedy_decode_early_exit(cuda):
    cfg = las.ASRConfig(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=5)
    model, _ = _models(cfg, 8, 4, cuda)
    model = copy.deepcopy(model)
    with torch.no_grad():
        model.char_trans.bias[EOS_ID] = 50.0
    x = torch.randn(3, 16, 5, device=cuda)
    with torch.inference_mode():
        enc_h, enc_lens = las.listener_apply(model.encoder, x,
                                             torch.tensor([16, 5, 0], device=cuda))
        comp_h = las.attention_precompute(model.attention, enc_h)
        got = kdec.greedy_decode(model, enc_h, comp_h, enc_lens, 9).cpu()
    assert (got[:, 0] == EOS_ID).all() and (got[:, 1:] == 0).all()


#: conf/default.yaml's asr.mdl widths (speller 2 x 256, attention 128, F = 512)
GREEDY_FLAGSHIP = dict(encoder_state_size=256, decoder_state_size=256, mlp_out_size=128,
                       feature_dim=40)
GREEDY_S = 64
GREEDY_STEPS = 100


def _greedy_case(cuda, sizes, B, seed, lm_hidden=128):
    """A seeded model and LM, random listener memory [B, GREEDY_S] with
    ragged lengths (0 and 1 among them) -> (model, lm, (enc_h, comp_h,
    enc_lens))."""
    cfg = las.ASRConfig(**sizes)
    model, lm = _models(cfg, lm_hidden, seed, cuda)
    g = torch.Generator().manual_seed(seed)
    enc_h = (torch.randn(B, GREEDY_S, cfg.enc_out_dim, generator=g) * 0.5).to(cuda)
    lens = torch.randint(0, GREEDY_S + 1, (B,), generator=g, dtype=torch.int32)
    lens[: min(B, 2)] = torch.tensor([1, 0], dtype=torch.int32)[: min(B, 2)]
    with torch.no_grad():
        comp_h = las.attention_precompute(model.attention, enc_h)
    return model, lm, (enc_h, comp_h, lens.to(cuda))


def _greedy_route_of(model, lm_, B):
    cfg = model.cfg
    return kdec.greedy_route(B, cfg.decoder_state_size, cfg.enc_out_dim, cfg.mlp_out_size,
                             GREEDY_S, cfg.vocab_size, lm_.cfg.hidden_size if lm_ else 0)


def _check_greedy_route(model, lm_, mem, steps, route):
    """One greedy_decode on ``route``: one launch counted, on the cluster
    counter too where route > 0; the tokens those of the plain decode by the
    smoke's near-tie rule -> the kernel's tokens."""
    name = "greedy_decode_lm" if lm_ is not None else "greedy_decode"
    with torch.inference_mode():
        before = dict(kdec.LAUNCHES)
        got = kdec.greedy_decode(model, *mem, steps, lm_, 0.5, route=route)
        torch.cuda.synchronize()
        assert kdec.LAUNCHES[name] == before[name] + 1
        assert kdec.LAUNCHES[f"{name}_cluster"] == before[f"{name}_cluster"] + (route > 0)
        want = kdec.greedy_decode_plain(model, *mem, steps, lm_, 0.5)
        gaps = plain_gaps(torch, model, *mem, want, lm_, 0.5)
    compare_tokens(f"{name} route {route}", got.cpu().numpy(), want.cpu().numpy(), gaps)
    return got


@pytest.mark.parametrize("route", ["by_shape", "one_row"])
@pytest.mark.parametrize("use_lm", [False, True], ids=["greedy", "greedy+lm"])
@pytest.mark.parametrize("B", [1, 8, 13, 16])
def test_greedy_routes_match_plain_at_the_flagship(cuda, B, use_lm, route):
    """K6 / K7 at the flagship width on the cluster route (the route by
    shape at every B) and on the one-row kernel."""
    model, lm, mem = _greedy_case(cuda, GREEDY_FLAGSHIP, B, seed=21)
    lm_ = lm if use_lm else None
    R = _greedy_route_of(model, lm_, B)
    assert R in kdec.GREEDY_TILE_ROWS
    _check_greedy_route(model, lm_, mem, GREEDY_STEPS, R if route == "by_shape" else 0)


@pytest.mark.parametrize("use_lm", [False, True], ids=["greedy", "greedy+lm"])
def test_greedy_cluster_every_tile_height(cuda, use_lm):
    """A cluster of 2 CTAs (H = 64, the LM's 8 units 4 a CTA) at every tile
    height, B = 5 a multiple of none but 1: the last tile's padding rows."""
    sizes = dict(encoder_state_size=16, decoder_state_size=64, mlp_out_size=16, feature_dim=5)
    model, lm, mem = _greedy_case(cuda, sizes, 5, seed=22, lm_hidden=8)
    lm_ = lm if use_lm else None
    cfg = model.cfg
    for R in kdec.GREEDY_TILE_ROWS:
        assert kdec.greedy_cluster_serves(64, cfg.enc_out_dim, 16, GREEDY_S, cfg.vocab_size,
                                          8 if use_lm else 0, R)
        _check_greedy_route(model, lm_, mem, 40, R)


@pytest.mark.parametrize("use_lm", [False, True], ids=["greedy", "greedy+lm"])
def test_greedy_cluster_route_early_exit(cuda, use_lm):
    """An EOS bias of +50: every row emits EOS at step 0 and SOS after it,
    the tiles stopping at once; of -50: no row emits EOS in all steps.
    Both on the cluster route by shape, equal to the plain decode."""
    model, lm, mem = _greedy_case(cuda, GREEDY_FLAGSHIP, 13, seed=23)
    lm_ = lm if use_lm else None
    R = _greedy_route_of(model, lm_, 13)
    assert R in kdec.GREEDY_TILE_ROWS
    with torch.inference_mode():
        m = eos_biased(torch, model, 50.0)
        got = kdec.greedy_decode(m, *mem, GREEDY_STEPS, lm_, 0.5).cpu()
        want = kdec.greedy_decode_plain(m, *mem, GREEDY_STEPS, lm_, 0.5).cpu()
    assert (got[:, 0] == EOS_ID).all() and (got[:, 1:] == 0).all()
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    got = _check_greedy_route(eos_biased(torch, model, -50.0), lm_, mem, GREEDY_STEPS, R)
    assert not bool((got == EOS_ID).any())


def test_greedy_one_row_route_for_shapes_no_cluster_serves(cuda):
    """H = 96 (3 CTAs) and, at H = 64, an LM of 36 units (not float4s a CTA)
    take the one-row kernel by shape: counted off the cluster counters."""
    for sizes, lm_hidden, use_lm in (
            (dict(encoder_state_size=16, decoder_state_size=96, mlp_out_size=24, feature_dim=5),
             8, False),
            (dict(encoder_state_size=16, decoder_state_size=64, mlp_out_size=16, feature_dim=5),
             36, True)):
        model, lm, mem = _greedy_case(cuda, sizes, 6, seed=24, lm_hidden=lm_hidden)
        lm_ = lm if use_lm else None
        assert _greedy_route_of(model, lm_, 6) == 0
        _check_greedy_route(model, lm_, mem, 40, 0)
    with pytest.raises(RuntimeError, match="ss_greedy_decode_lm"):
        kdec.greedy_decode(model, *mem, 40, lm, 0.5, route=2)


@pytest.mark.parametrize("sr", [8000, 16000, 22050])
def test_fbank_kernel_matches_plain(cuda, sr):
    """K11 against fbank_plain by the smoke's rule (log domain 1e-4 above the
    frame's floor, linear domain 1e-5 of the row's largest energy): a full
    row, one shorter than the pad width, one sample, and a frame count that
    is not a multiple of the kernel's tile."""
    rng = np.random.default_rng(sr)
    n_fft, hop = frontend.frame_params(sr)
    pad = n_fft // 2
    lens = np.array([sr // 2 + 13, pad // 3, 1, pad + 37, sr // 3])
    buf = np.zeros((len(lens), int(lens.max())), np.float32)
    for i, n in enumerate(lens):
        buf[i, :n] = 0.3 * rng.standard_normal(n)
    y = torch.from_numpy(buf).to(cuda)
    yp = frontend.reflect_padded(y, torch.from_numpy(lens).to(cuda), pad)
    nf = int(frontend.num_frames(buf.shape[1], n_fft, hop))
    assert nf % 32 != 0
    wbasis, mel, wil = frontend._projections(sr, 40, 25, 10, yp.device)
    before = kfe.LAUNCHES["fbank"]
    got = kfe.fbank(yp, wbasis, mel, nf, n_fft, hop, wil)
    torch.cuda.synchronize()
    assert kfe.LAUNCHES["fbank"] == before + 1
    want = kfe.fbank_plain(yp, wbasis, mel, nf, n_fft, hop)
    log_err, lin_err = fbank_errors(torch, got, want)
    assert log_err <= FBANK_LOG_TOL and lin_err <= FBANK_LIN_TOL
    # without the caller's interleaved basis the wrapper builds it
    torch.testing.assert_close(kfe.fbank(yp, wbasis, mel, nf, n_fft, hop), got, atol=0, rtol=0)
    # a short buffer: fewer frames than one tile
    got = kfe.fbank(yp[:, : 4 * hop + n_fft], wbasis, mel, 5, n_fft, hop, wil)
    want = kfe.fbank_plain(yp[:, : 4 * hop + n_fft], wbasis, mel, 5, n_fft, hop)
    log_err, lin_err = fbank_errors(torch, got, want)
    assert got.shape == (5, 5, 40) and log_err <= FBANK_LOG_TOL and lin_err <= FBANK_LIN_TOL


def test_fbank_kernel_is_forward_only(cuda):
    n_fft, hop = frontend.frame_params(8000)
    wbasis, mel, wil = frontend._projections(8000, 40, 25, 10, torch.device("cuda"))
    yp = torch.randn(2, 1000, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        kfe.fbank(yp, wbasis, mel, 5, n_fft, hop, wil)


def test_streaming_frontend_on_the_card_launches_the_kernel(cuda):
    rng = np.random.default_rng(1)
    y = (0.3 * rng.standard_normal(40000)).astype(np.float32)
    before = kfe.LAUNCHES["fbank"]
    sfe = frontend.StreamingFrontend(16000, device=cuda)
    frames = np.concatenate([sfe.push(c) for c in np.array_split(y, 7)] + [sfe.close()], 0)
    assert kfe.LAUNCHES["fbank"] > before
    want = frontend.compute_fbank(y, 16000, device="cpu")
    assert frames.shape == want.shape
    log_err, lin_err = fbank_errors(torch, torch.from_numpy(frames), torch.from_numpy(want))
    assert log_err <= FBANK_LOG_TOL and lin_err <= FBANK_LIN_TOL


def test_frontend_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(0)
    buf = (0.3 * rng.standard_normal((3, 11025))).astype(np.float32)
    lens = torch.tensor([11025, 100, 1])
    want, wl = frontend.log_mel_fbank_batch(torch.from_numpy(buf), lens, 22050)
    got, gl = frontend.log_mel_fbank_batch(torch.from_numpy(buf).to(cuda), lens.to(cuda), 22050)
    assert torch.equal(gl.cpu(), wl)
    torch.testing.assert_close(got[0].cpu(), want[0], atol=1e-4, rtol=0)


def test_transcriber_on_the_card_matches_the_cpu(cuda):
    cfg = las.ASRConfig(encoder_state_size=16, decoder_state_size=16, mlp_out_size=8)
    rng = np.random.default_rng(1)
    sigs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (3000, 0, 4500)]
    out = []
    for dev in ("cpu", cuda):
        model, lm = _models(cfg, 8, 5, dev)
        t = Transcriber(model, lm=lm, lm_weight=0.5, sr=8000, max_steps=12, t_bucket=16)
        out.append(t.transcribe_signal_batch(sigs))
    assert out[0] == out[1]


def _memory(model, rng, cuda, B=6, T=40):
    cfg = model.cfg
    x = torch.from_numpy(rng.standard_normal((B, T, cfg.feature_dim)).astype(np.float32)).to(cuda)
    x_lens = torch.tensor([T, 33, 9, 3, 17, T][:B], dtype=torch.int32, device=cuda)
    enc_h, enc_lens = las.listener_apply(model.encoder, x, x_lens)
    return enc_h, las.attention_precompute(model.attention, enc_h), enc_lens


def _assert_frontier_matches(got, want, gaps):
    """Tokens/parents equal up to a first divergence at a plain near-tie
    (the K + 1 best candidates within 1e-4: float32 sums in another order
    may order them otherwise; at K = 16 such gaps, exact ties included, come
    every few steps); at least half the rows never diverge, and on those
    done, lengths and scores agree (scores within 1e-4)."""
    toks, parents, scores, done, hyp = (t.cpu().numpy() for t in got)
    w_toks, w_parents, w_scores, w_done, w_hyp = (t.cpu().numpy() for t in want)
    whole = []
    for b in range(toks.shape[1]):
        diff = ((toks[:, b] != w_toks[:, b]) | (parents[:, b] != w_parents[:, b])).any(1)
        if not diff.any():
            whole.append(b)
            continue
        t = int(diff.nonzero()[0][0])
        assert gaps[b, t] < 1e-4, f"row {b} diverges at step {t}, plain gap {gaps[b, t]}"
    assert 2 * len(whole) >= toks.shape[1]
    np.testing.assert_array_equal(done[whole], w_done[whole])
    np.testing.assert_array_equal(hyp[whole], w_hyp[whole])
    np.testing.assert_allclose(scores[whole], w_scores[whole], rtol=0, atol=1e-4)


@pytest.mark.parametrize("sizes,lm_hidden", [
    (dict(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=5), 8),
    (dict(encoder_state_size=24, decoder_state_size=40, mlp_out_size=300, feature_dim=7), 36),
])
@pytest.mark.parametrize("K", [3, 16])
@pytest.mark.parametrize("use_lm", [False, True], ids=["beam", "beam+lm"])
def test_beam_decode_matches_plain(cuda, sizes, lm_hidden, K, use_lm):
    model, lm = _models(las.ASRConfig(**sizes), lm_hidden, 6, cuda)
    lm_ = lm if use_lm else None
    with torch.inference_mode():
        enc_h, comp_h, enc_lens = _memory(model, np.random.default_rng(8), cuda)
        key = "beam_decode_lm" if use_lm else "beam_decode"
        before = kbeam.LAUNCHES[key]
        got = kbeam.beam_device(model, enc_h, comp_h, enc_lens, K, 30, lm_, 0.6)
        torch.cuda.synchronize()
        assert kbeam.LAUNCHES[key] == before + 1
        want = kbeam.beam_scan_plain(model, enc_h, comp_h, enc_lens, K, 30, lm_, 0.6)
        cands = replay_frontier(torch, model, lm_, 0.6, enc_h, comp_h, enc_lens, *want[:2])[0]
    _assert_frontier_matches(got, want, frontier_gaps(torch, cands, K, 30))


@pytest.mark.parametrize("K,use_lm", [(3, False), (16, True)], ids=["beam3", "beam16+lm"])
def test_beam_decode_long_memory_matches_plain(cuda, K, use_lm):
    """At the flagship width, S = 1500 encoder steps (120 s, the longest
    window the server takes) puts the K beams' attention weights past the
    one-block kernel's shared buffer, into its global scratch.  Against the
    plain frontier; and rows no longer than 1000 steps give bit for bit what
    the shared-memory path gives them at S = 1000 (padding steps add exact
    zeros).  The one-block route by request (K = 3 takes the cluster route
    by shape, whose split of the memory steps follows S)."""
    model, lm = _models(las.ASRConfig(), 128, 11, cuda)
    lm_ = lm if use_lm else None
    rng = np.random.default_rng(12)
    S = 1500
    enc_h = torch.from_numpy(
        rng.standard_normal((4, S, model.cfg.enc_out_dim)).astype(np.float32)).to(cuda)
    enc_lens = torch.tensor([S, 1000, 700, 1], dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        comp_h = las.attention_precompute(model.attention, enc_h)
        got = kbeam.beam_device(model, enc_h, comp_h, enc_lens, K, 12, lm_, 0.5, route=(0, 0))
        want = kbeam.beam_scan_plain(model, enc_h, comp_h, enc_lens, K, 12, lm_, 0.5)
        cands = replay_frontier(torch, model, lm_, 0.5, enc_h, comp_h, enc_lens, *want[:2])[0]
        short = kbeam.beam_device(model, enc_h[1:, :1000].contiguous(),
                                  comp_h[1:, :1000].contiguous(), enc_lens[1:], K, 12, lm_, 0.5,
                                  route=(0, 0))
    _assert_frontier_matches(got, want, frontier_gaps(torch, cands, K, 12))
    for a, b in zip(got, short):
        assert torch.equal(a[..., 1:, :] if a.dim() == 3 else a[1:], b)


CLUSTER_SIZES = dict(encoder_state_size=32, decoder_state_size=64, mlp_out_size=32, feature_dim=5)


@pytest.mark.parametrize("K,U,C", [(1, 1, 2), (1, 2, 2), (3, 1, 2), (3, 2, 2), (4, 2, 2), (8, 1, 2),
                                   (3, 1, 4), (3, 2, 4), (8, 1, 4), (9, 1, 2), (16, 1, 2),
                                   (12, 1, 4), (16, 1, 4)])
@pytest.mark.parametrize("use_lm", [False, True], ids=["beam", "beam+lm"])
def test_beam_cluster_matches_plain(cuda, K, U, C, use_lm):
    """K8's cluster route (clusters of C CTAs with 128 gate columns each: H
    = 64 for 2, 128 for 4; one or two utterances a cluster, B = 5 so that a
    cluster holds a missing utterance; K 9-16 on the 16-row variant) against
    the plain frontier by the near-tie rule, its counter, and a second run
    bit-equal to the first."""
    sizes = dict(CLUSTER_SIZES, decoder_state_size=32 * C)
    model, lm = _models(las.ASRConfig(**sizes), 32, 9, cuda)
    lm_ = lm if use_lm else None
    with torch.inference_mode():
        enc_h, comp_h, enc_lens = _memory(model, np.random.default_rng(K + U), cuda, B=5, T=64)
        before = dict(kbeam.LAUNCHES)
        got = kbeam.beam_device(model, enc_h, comp_h, enc_lens, K, 30, lm_, 0.6, route=(C, U))
        torch.cuda.synchronize()
        key = "beam_decode_lm" if use_lm else "beam_decode"
        assert kbeam.LAUNCHES[key] == before[key] + 1
        assert kbeam.LAUNCHES[f"{key}_cluster"] == before[f"{key}_cluster"] + 1
        want = kbeam.beam_scan_plain(model, enc_h, comp_h, enc_lens, K, 30, lm_, 0.6)
        cands = replay_frontier(torch, model, lm_, 0.6, enc_h, comp_h, enc_lens, *want[:2])[0]
        again = kbeam.beam_device(model, enc_h, comp_h, enc_lens, K, 30, lm_, 0.6, route=(C, U))
    _assert_frontier_matches(got, want, frontier_gaps(torch, cands, K, 30))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K,U", [(3, 1), (3, 2), (8, 1), (16, 1)])
@pytest.mark.parametrize("use_lm", [False, True], ids=["beam", "beam+lm"])
def test_beam_cluster_long_memory_matches_plain(cuda, K, U, use_lm):
    """At the flagship width (clusters of 8), S = 1500 encoder steps: the
    attention split over the cluster, 188 steps a CTA, against the plain
    frontier, and a second run bit-equal to the first."""
    model, lm = _models(las.ASRConfig(), 128, 13, cuda)
    lm_ = lm if use_lm else None
    rng = np.random.default_rng(14)
    S = 1500
    enc_h = torch.from_numpy(
        rng.standard_normal((3, S, model.cfg.enc_out_dim)).astype(np.float32)).to(cuda)
    enc_lens = torch.tensor([S, 700, 1], dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        comp_h = las.attention_precompute(model.attention, enc_h)
        got = kbeam.beam_device(model, enc_h, comp_h, enc_lens, K, 12, lm_, 0.5, route=(8, U))
        want = kbeam.beam_scan_plain(model, enc_h, comp_h, enc_lens, K, 12, lm_, 0.5)
        cands = replay_frontier(torch, model, lm_, 0.5, enc_h, comp_h, enc_lens, *want[:2])[0]
        again = kbeam.beam_device(model, enc_h, comp_h, enc_lens, K, 12, lm_, 0.5, route=(8, U))
    _assert_frontier_matches(got, want, frontier_gaps(torch, cands, K, 12))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K,U", [(4, 1), (4, 2), (16, 1)])
@pytest.mark.parametrize("use_lm", [False, True], ids=["beam", "beam+lm"])
def test_beam_cluster_early_exit(cuda, K, U, use_lm):
    """With an EOS bias of 50 every beam ends within two steps: the cluster
    route then writes SOS tokens and identity parents, equal to the plain
    frontier."""
    model, lm = _models(las.ASRConfig(**CLUSTER_SIZES), 32, 4, cuda)
    model = copy.deepcopy(model)
    with torch.no_grad():
        model.char_trans.bias[EOS_ID] = 50.0
    lm_ = lm if use_lm else None
    with torch.inference_mode():
        enc_h, comp_h, enc_lens = _memory(model, np.random.default_rng(2), cuda, B=3, T=16)
        got = kbeam.beam_device(model, enc_h, comp_h, enc_lens, K, 9, lm_, 0.5, route=(2, U))
        want = kbeam.beam_scan_plain(model, enc_h, comp_h, enc_lens, K, 9, lm_, 0.5)
    assert bool(got[3].all()) and (got[0][-1] == 0).all()
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert torch.equal(g, w)
    torch.testing.assert_close(got[2], want[2], atol=1e-4, rtol=0)


def test_beam_takes_the_route_of_its_shape_and_refuses_one_that_does_not_serve(cuda):
    cfg = las.ASRConfig()
    H, F, M, V = cfg.decoder_state_size, cfg.enc_out_dim, cfg.mlp_out_size, cfg.vocab_size
    assert kbeam.beam_route(H, F, M, V, 128, 64, 3, 8) == (8, 1)
    assert kbeam.beam_route(H, F, M, V, 128, 64, 3, 16) == (8, 2)
    assert kbeam.beam_route(H, F, M, V, 128, 64, 8, 16) == (8, 1)  # K > 4: 8 rows, 16 clusters
    assert kbeam.beam_route(H, F, M, V, 128, 64, 16, 8) == (8, 1)  # the 16-row variant
    model, lm = _models(las.ASRConfig(**CLUSTER_SIZES), 32, 3, cuda)
    with torch.inference_mode():
        enc_h, comp_h, enc_lens = _memory(model, np.random.default_rng(5), cuda, B=3, T=16)
        before = kbeam.LAUNCHES["beam_decode_lm_cluster"]
        by_shape = kbeam.beam_device(model, enc_h, comp_h, enc_lens, 3, 6, lm, 0.5)
        assert kbeam.LAUNCHES["beam_decode_lm_cluster"] == before + 1
        kbeam.beam_device(model, enc_h, comp_h, enc_lens, 16, 6, lm, 0.5)
        assert kbeam.LAUNCHES["beam_decode_lm_cluster"] == before + 2
        with pytest.raises(ValueError, match="serves"):
            kbeam.beam_device(model, enc_h, comp_h, enc_lens, 3, 6, lm, 0.5, route=(2, 4))
    assert by_shape[0].shape == (6, 3, 3)


@pytest.mark.parametrize("K,U,S", [(3, 2, 20000), (16, 1, 8000)])
@pytest.mark.parametrize("use_lm", [False, True], ids=["beam", "beam+lm"])
def test_beam_cluster_global_attention_scratch_matches_plain(cuda, K, U, S, use_lm):
    """At the flagship width, memory long enough that the cluster route's
    plan puts the attention weights in the global scratch: against the
    plain frontier, and a second run bit-equal to the first."""
    model, lm = _models(las.ASRConfig(), 128, 15, cuda)
    cfg = model.cfg
    plan = kbeam.cluster_plan(cfg.decoder_state_size, cfg.enc_out_dim, cfg.mlp_out_size,
                              cfg.vocab_size, 128 if use_lm else 0, S, K, 8, U)
    assert plan is not None and not plan[1]
    lm_ = lm if use_lm else None
    rng = np.random.default_rng(16)
    enc_h = torch.from_numpy(
        rng.standard_normal((3, S, cfg.enc_out_dim)).astype(np.float32)).to(cuda)
    enc_lens = torch.tensor([S, S // 3, 1], dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        comp_h = las.attention_precompute(model.attention, enc_h)
        got = kbeam.beam_device(model, enc_h, comp_h, enc_lens, K, 8, lm_, 0.5, route=(8, U))
        want = kbeam.beam_scan_plain(model, enc_h, comp_h, enc_lens, K, 8, lm_, 0.5)
        cands = replay_frontier(torch, model, lm_, 0.5, enc_h, comp_h, enc_lens, *want[:2])[0]
        again = kbeam.beam_device(model, enc_h, comp_h, enc_lens, K, 8, lm_, 0.5, route=(8, U))
    _assert_frontier_matches(got, want, frontier_gaps(torch, cands, K, 8))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_beam_cluster_plan_of_the_kernel_equals_its_mirror(cuda):
    """``cluster_plan`` in Python against the one ``csrc/beam_decode.cu``
    launches with (``ss_beam_cluster_plan``, from the card's shared memory a
    block) at the flagship width: floats, the attention's place and the
    ring stages, or no plan, for K 1-16, with and without the LM, one and
    two utterances a cluster, S = 64, 1500 and 8000."""
    cfg = las.ASRConfig()
    dims = (cfg.decoder_state_size, cfg.enc_out_dim, cfg.mlp_out_size, cfg.vocab_size)
    served = 0
    for K in range(1, 17):
        for HL in (0, 128):
            for U in (1, 2):
                for S in (64, 1500, 8000):
                    want = kbeam.cluster_plan(*dims, HL, S, K, 8, U)
                    got = kbeam.device_cluster_plan(*dims, HL, S, K, 8, U, cuda)
                    assert got == want, (K, HL, U, S)
                    served += want is not None
    assert served == 16 * 2 * 3 + 4 * 2 * 3  # U = 1 at every K, U = 2 at K <= 4


@pytest.mark.parametrize("use_lm", [False, True], ids=["beam", "beam+lm"])
def test_beam_decode_early_exit(cuda, use_lm):
    cfg = las.ASRConfig(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=5)
    model, lm = _models(cfg, 8, 4, cuda)
    model = copy.deepcopy(model)
    with torch.no_grad():
        model.char_trans.bias[EOS_ID] = 50.0
    lm_ = lm if use_lm else None
    with torch.inference_mode():
        enc_h, comp_h, enc_lens = _memory(model, np.random.default_rng(2), cuda, B=3, T=16)
        got = kbeam.beam_device(model, enc_h, comp_h, enc_lens, 4, 9, lm_, 0.5)
        want = kbeam.beam_scan_plain(model, enc_h, comp_h, enc_lens, 4, 9, lm_, 0.5)
    assert bool(got[3].all()) and (got[0][-1] == 0).all()
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g, w)
    torch.testing.assert_close(got[2], want[2], atol=1e-4, rtol=0)


@pytest.mark.parametrize("tf", [1.0, 0.5, None], ids=["teacher", "sampled", "greedy"])
@pytest.mark.parametrize("sizes", [
    dict(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=5),
    dict(encoder_state_size=24, decoder_state_size=40, mlp_out_size=300, feature_dim=7),
])
def test_spell_fwd_matches_plain(cuda, tf, sizes):
    cfg = las.ASRConfig(**sizes)
    model, _ = _models(cfg, 8, 9, cuda)
    B, L = 6, 11
    g = torch.Generator().manual_seed(3)
    if tf is None:
        tf_draws = torch.zeros(L, device=cuda)
        gumbel = torch.zeros(L, B, VOCAB_SIZE, device=cuda)
    else:
        tf_draws, gumbel = las.draw_scheduled_sampling(L, B, tf, cfg, g, device=cuda)
    ids = torch.randint(0, VOCAB_SIZE, (L, B), generator=g).to(cuda)
    with torch.inference_mode():
        enc_h, comp_h, enc_lens = _memory(model, np.random.default_rng(5), cuda, B=B)
        temb = model.embed.weight[ids]
        before = kspell.LAUNCHES["spell_fwd"]
        got = kspell.spell_fwd(model, enc_h, comp_h, enc_lens, tf_draws, gumbel, temb)
        torch.cuda.synchronize()
        assert kspell.LAUNCHES["spell_fwd"] == before + 1
        want = kspell.spell_fwd_plain(model, enc_h, comp_h, enc_lens, tf_draws, gumbel, temb)
    for name, a, b in zip(("logits", "a", "h1s", "c1s", "h2s", "c2s", "fed"), got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=name)


def test_gradient_flows_through_spellcore_and_direct_kernel_calls_refuse_it(cuda):
    """las.attend_and_spell differentiates through SpellCore (K9 + K10) on
    the card; a direct spell_fwd / lstm_fwd call whose inputs need a
    gradient raises, since autograd cannot see the kernels."""
    cfg = las.ASRConfig(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=5)
    model, _ = _models(cfg, 8, 9, cuda)
    enc_h = torch.randn(2, 4, 16, device=cuda, requires_grad=True)
    lens = torch.tensor([4, 2], device=cuda)
    before = dict(kspell.LAUNCHES)
    logits, _ = las.attend_and_spell(model, enc_h, lens, 3)
    logits.square().sum().backward()
    assert kspell.LAUNCHES["spell_fwd"] == before["spell_fwd"] + 1
    assert kspell.LAUNCHES["spell_bwd"] == before["spell_bwd"] + 1
    assert enc_h.grad is not None and model.decoder.layer_1.weight_ih.grad is not None
    comp = las.attention_precompute(model.attention, enc_h)
    zeros = torch.zeros(3, 2, VOCAB_SIZE, device=cuda)
    with pytest.raises(RuntimeError, match="SpellCore"):
        kspell.spell_fwd(model, enc_h, comp, lens, torch.ones(3, device=cuda), zeros,
                         torch.zeros(3, 2, 8, device=cuda))
    gx = torch.randn(1, 3, 2, 32, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="LSTMSeq"):
        klstm.lstm_fwd(gx, torch.zeros(1, 8, 32, device=cuda), lens, (False,))


@pytest.mark.parametrize("D,reverse", [(1, (False,)), (1, (True,)), (2, (False, True))])
@pytest.mark.parametrize("T,B,H", [(13, 5, 40), (1, 1, 8), (7, 17, 300)])
def test_lstm_bwd_matches_plain(cuda, D, reverse, T, B, H):
    rng = np.random.default_rng(T * B + H + 1)
    gx = torch.from_numpy(rng.standard_normal((D, T, B, 4 * H)).astype(np.float32)).to(cuda)
    whh = torch.from_numpy((rng.standard_normal((D, H, 4 * H)) / np.sqrt(H)).astype(np.float32))
    whh = whh.to(cuda)
    dy = torch.from_numpy(rng.standard_normal((D, T, B, H)).astype(np.float32)).to(cuda)
    lens = rng.integers(0, T + 1, size=B)
    lens[: min(B, 2)] = (0, 1)[: min(B, 2)]
    lengths = torch.from_numpy(lens.astype(np.int32)).to(cuda)
    y, cs = klstm.lstm_fwd(gx, whh, lengths, reverse)
    before = klstm.LAUNCHES["lstm_bwd"]
    dgx, dwhh = klstm.lstm_bwd(gx, whh, lengths, y, cs, dy, reverse)
    torch.cuda.synchronize()
    assert klstm.LAUNCHES["lstm_bwd"] == before + 1
    for d in range(D):
        want = klstm.lstm_bwd_plain(gx[d], whh[d], lengths, y[d], cs[d], dy[d], reverse[d])
        torch.testing.assert_close(dgx[d], want, atol=1e-5, rtol=0)
        want_w = torch.einsum("tbh,tbg->hg", klstm.predecessors(y[d], reverse[d]), want)
        torch.testing.assert_close(dwhh[d], want_w, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("D,reverse", [(1, (False,)), (1, (True,)), (2, (False, True))])
@pytest.mark.parametrize("H,route,T,B", [
    (64, (1, 8), 13, 5), (64, (2, 4), 9, 11), (128, (2, 8), 7, 17), (128, (4, 4), 11, 6),
    (256, (8, 8), 9, 13), (256, (8, 4), 12, 7), (256, (8, 5), 10, 12), (128, (4, 6), 8, 13),
    (64, (1, 4), 1, 1),
    (384, (0, 0), 6, 5), (256, (0, 0), 5, 3),
], ids=lambda v: str(v).replace(" ", ""))
def test_lstm_bwd_routes_match_plain(cuda, D, reverse, H, route, T, B):
    """K3 on the cluster route at C = 1, 2, 4, 8 with tiles of 4 and 8 rows,
    and on the streaming route: B not a multiple of the tile, lengths 0 and
    1, both directions and one alone; dgx and dW_hh against the plain
    version, the route's counter, and a second run bit-equal to the first
    (the reduce-scatter adds its slots in a fixed order)."""
    rng = np.random.default_rng(T * B + H + 1)
    gx = torch.from_numpy(rng.standard_normal((D, T, B, 4 * H)).astype(np.float32)).to(cuda)
    whh = torch.from_numpy((rng.standard_normal((D, H, 4 * H)) / np.sqrt(H)).astype(np.float32))
    whh = whh.to(cuda)
    dy = torch.from_numpy(rng.standard_normal((D, T, B, H)).astype(np.float32)).to(cuda)
    lens = rng.integers(0, T + 1, size=B)
    lens[: min(B, 2)] = (0, 1)[: min(B, 2)]
    if B > 2:
        lens[2] = T
    lengths = torch.from_numpy(lens.astype(np.int32)).to(cuda)
    y, cs = klstm.lstm_fwd(gx, whh, lengths, reverse)
    before = dict(klstm.LAUNCHES)
    dgx, dwhh = klstm.lstm_bwd(gx, whh, lengths, y, cs, dy, reverse, route=route)
    torch.cuda.synchronize()
    assert klstm.LAUNCHES["lstm_bwd"] == before["lstm_bwd"] + 1
    assert klstm.LAUNCHES["lstm_bwd_cluster"] == before["lstm_bwd_cluster"] + (route[0] > 0)
    for d in range(D):
        want = klstm.lstm_bwd_plain(gx[d], whh[d], lengths, y[d], cs[d], dy[d], reverse[d])
        torch.testing.assert_close(dgx[d], want, atol=1e-5, rtol=0)
        want_w = torch.einsum("tbh,tbg->hg", klstm.predecessors(y[d], reverse[d]), want)
        torch.testing.assert_close(dwhh[d], want_w, atol=1e-4, rtol=1e-5)
    again = klstm.lstm_bwd(gx, whh, lengths, y, cs, dy, reverse, route=route)
    assert torch.equal(again[0], dgx) and torch.equal(again[1], dwhh)


def test_lstm_bwd_takes_the_route_of_its_shape_and_refuses_one_that_does_not_serve(cuda):
    H, T, B = 256, 6, 9
    assert klstm.lstm_bwd_route(H, B, 2)[0] == 8 and klstm.lstm_bwd_route(384, B, 2) == (0, 0)
    g = torch.Generator().manual_seed(0)
    gx = torch.randn(2, T, B, 4 * H, generator=g).to(cuda)
    whh = (torch.randn(2, H, 4 * H, generator=g) / 16).to(cuda)
    dy = torch.randn(2, T, B, H, generator=g).to(cuda)
    lengths = torch.full((B,), T, dtype=torch.int32, device=cuda)
    y, cs = klstm.lstm_fwd(gx, whh, lengths, (False, True))
    before = klstm.LAUNCHES["lstm_bwd_cluster"]
    by_shape = klstm.lstm_bwd(gx, whh, lengths, y, cs, dy, (False, True))
    assert klstm.LAUNCHES["lstm_bwd_cluster"] == before + 1
    streamed = klstm.lstm_bwd(gx, whh, lengths, y, cs, dy, (False, True), route=(0, 0))
    assert klstm.LAUNCHES["lstm_bwd_cluster"] == before + 1
    torch.testing.assert_close(by_shape[0], streamed[0], atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="serves"):
        klstm.lstm_bwd(gx, whh, lengths, y, cs, dy, (False, True), route=(4, 8))


@pytest.mark.parametrize("D,reverse", [(1, (False,)), (1, (True,)), (2, (False, True))])
@pytest.mark.parametrize("H,route,T,B", [
    (64, (1, 8), 13, 5), (64, (2, 4), 9, 11), (128, (2, 8), 7, 17), (128, (4, 4), 11, 6),
    (256, (8, 8), 9, 13), (256, (8, 4), 12, 7), (256, (8, 5), 10, 12), (256, (8, 6), 8, 13),
    (64, (1, 4), 1, 1), (256, (8, 8), 48, 64),
    (384, (0, 0), 6, 5), (256, (0, 0), 5, 3),
], ids=lambda v: str(v).replace(" ", ""))
def test_lstm_fwd_routes_match_plain(cuda, D, reverse, H, route, T, B):
    """K2 on the cluster route at C = 1, 2, 4, 8 with every tile height, the
    TAE's batch (16 clusters of 8 where 15 fit: a second wave), and on the
    streaming route: B not a multiple of the tile, lengths 0 and 1, both
    directions and one alone; y and cs against the plain loop, the route's
    counter, and a second run bit-equal to the first."""
    rng = np.random.default_rng(T * B + H + 2)
    gx = torch.from_numpy(rng.standard_normal((D, T, B, 4 * H)).astype(np.float32)).to(cuda)
    whh = torch.from_numpy((rng.standard_normal((D, H, 4 * H)) / np.sqrt(H)).astype(np.float32))
    whh = whh.to(cuda)
    lens = rng.integers(0, T + 1, size=B)
    lens[: min(B, 2)] = (0, 1)[: min(B, 2)]
    if B > 2:
        lens[2] = T
    lengths = torch.from_numpy(lens.astype(np.int32)).to(cuda)
    before = dict(klstm.LAUNCHES)
    y, cs = klstm.lstm_fwd(gx, whh, lengths, reverse, route=route)
    torch.cuda.synchronize()
    assert klstm.LAUNCHES["lstm_fwd"] == before["lstm_fwd"] + 1
    assert klstm.LAUNCHES["lstm_fwd_cluster"] == before["lstm_fwd_cluster"] + (route[0] > 0)
    for d in range(D):
        y_ref, cs_ref = klstm.lstm_seq_plain(gx[d], whh[d], lengths, reverse[d])
        torch.testing.assert_close(y[d], y_ref, atol=1e-5, rtol=0)
        torch.testing.assert_close(cs[d], cs_ref, atol=1e-5, rtol=0)
    again = klstm.lstm_fwd(gx, whh, lengths, reverse, route=route)
    assert torch.equal(again[0], y) and torch.equal(again[1], cs)


def test_lstm_fwd_takes_the_route_of_its_shape_and_refuses_one_that_does_not_serve(cuda):
    H, T, B = 256, 6, 9
    assert klstm.lstm_fwd_route(H, B, 2) == (8, 4) and klstm.lstm_fwd_route(384, B, 2) == (0, 0)
    g = torch.Generator().manual_seed(1)
    gx = torch.randn(2, T, B, 4 * H, generator=g).to(cuda)
    whh = (torch.randn(2, H, 4 * H, generator=g) / 16).to(cuda)
    lengths = torch.full((B,), T, dtype=torch.int32, device=cuda)
    before = klstm.LAUNCHES["lstm_fwd_cluster"]
    by_shape = klstm.lstm_fwd(gx, whh, lengths, (False, True))
    assert klstm.LAUNCHES["lstm_fwd_cluster"] == before + 1
    streamed = klstm.lstm_fwd(gx, whh, lengths, (False, True), route=(0, 0))
    assert klstm.LAUNCHES["lstm_fwd_cluster"] == before + 1
    for a, b in zip(by_shape, streamed):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="serves"):
        klstm.lstm_fwd(gx, whh, lengths, (False, True), route=(4, 8))


def test_lstm_fwd_resident_clusters_match_the_route_table(cuda):
    """The card holds as many forward clusters as the route's table says
    (``CARD_CLUSTERS``), at every tile height."""
    for R in klstm.TILE_ROWS:
        assert klstm.resident_clusters(256, 8, R, cuda, forward=True) == klstm.CARD_CLUSTERS[8]


@pytest.mark.parametrize("sr", [16000, 22050])
@pytest.mark.parametrize("B,n", [(1, 1), (1, 40001), (3, 20000), (70, 30011)],
                         ids=["one-sample", "B1", "small-grid", "full-tiles"])
def test_fbank_kernel_tiles_and_edges(cuda, sr, B, n):
    """K11 on both tile sizes (a grid under half of the SMs takes tiles of
    64 frames, a larger one 128), frame counts that are no multiple of
    either, B = 1 and a one-sample row, at both sample rates."""
    rng = np.random.default_rng(sr + B + n)
    n_fft, hop = frontend.frame_params(sr)
    pad = n_fft // 2
    lens = rng.integers(1, n + 1, size=B)
    lens[0] = n
    buf = np.zeros((B, n), np.float32)
    for i, k in enumerate(lens):
        t = np.arange(k) / sr
        buf[i, :k] = 0.2 * np.sin(2 * np.pi * 440.0 * (i + 1) * t) + 0.05 * rng.standard_normal(k)
    yp = frontend.reflect_padded(torch.from_numpy(buf).to(cuda), torch.from_numpy(lens).to(cuda),
                                 pad)
    nf = int(frontend.num_frames(n, n_fft, hop))
    wbasis, mel, wil = frontend._projections(sr, 40, 25, 10, yp.device)
    got = kfe.fbank(yp, wbasis, mel, nf, n_fft, hop, wil)
    torch.cuda.synchronize()
    want = kfe.fbank_plain(yp, wbasis, mel, nf, n_fft, hop)
    log_err, lin_err = fbank_errors(torch, got, want)
    assert got.shape == (B, nf, 40) and bool(torch.isfinite(got).all())
    assert log_err <= FBANK_LOG_TOL and lin_err <= FBANK_LIN_TOL
    assert torch.equal(kfe.fbank(yp, wbasis, mel, nf, n_fft, hop, wil), got)


@pytest.mark.parametrize("tf", [1.0, 0.5], ids=["teacher", "sampled"])
@pytest.mark.parametrize("sizes", [
    dict(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=5),
    dict(encoder_state_size=24, decoder_state_size=40, mlp_out_size=300, feature_dim=7),
])
def test_spell_bwd_matches_plain(cuda, tf, sizes):
    from ss_asr_tpu_torch.ops.kernels.decode import speller_weights

    cfg = las.ASRConfig(**sizes)
    model, _ = _models(cfg, 8, 10, cuda)
    B, L = 6, 11
    g = torch.Generator().manual_seed(4)
    tf_draws, gumbel = las.draw_scheduled_sampling(L, B, tf, cfg, g, device=cuda)
    ids = torch.randint(0, VOCAB_SIZE, (L, B), generator=g).to(cuda)
    with torch.no_grad():
        enc_h, comp_h, enc_lens = _memory(model, np.random.default_rng(6), cuda, B=B)
        S = enc_h.shape[1]
        streams = kspell.spell_fwd(model, enc_h, comp_h, enc_lens, tf_draws, gumbel,
                                   model.embed.weight[ids])[1:]
        dlogits = torch.randn(L, B, VOCAB_SIZE, generator=g).to(cuda)
        daext = torch.randn(L, B, S, generator=g).to(cuda)
        W = [w.detach() for w in speller_weights(model)]
        before = kspell.LAUNCHES["spell_bwd"]
        got = kspell.spell_bwd(enc_h, comp_h, dlogits, daext, streams, W)
        torch.cuda.synchronize()
        assert kspell.LAUNCHES["spell_bwd"] == before + 1
        want = kspell.spell_bwd_plain(enc_h, comp_h, dlogits, daext, streams, W)
    for name, a, b in zip(("dg1", "dg2", "de", "dqp", "demb"), got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


#: K9 / K10's cluster route at the flagship width (conf/default.yaml asr.mdl), at
#: the ASR step's, the TAE step's and the alignment pass's (B, L, S); and a
#: small width whose cluster has 2 CTAs
FLAGSHIP = dict(encoder_state_size=256, decoder_state_size=256, mlp_out_size=128, feature_dim=40)
SMALL = dict(encoder_state_size=16, decoder_state_size=64, mlp_out_size=16, feature_dim=5)
SPELL_ROUTE_CASES = [(FLAGSHIP, 32, 48, 64), (FLAGSHIP, 64, 48, 48), (FLAGSHIP, 16, 16, 64),
                     (SMALL, 6, 11, 9)]
SPELL_ROUTE_IDS = ["asr", "tae", "detail", "small"]


def _spell_case(cuda, sizes, B, L, S, seed):
    """A seeded model, memory and draws at tf 0.9 -> (model, spell_fwd args,
    the route by shape)."""
    cfg = las.ASRConfig(**sizes)
    model, _ = _models(cfg, 8, seed, cuda)
    g = torch.Generator().manual_seed(seed)
    enc_h = (torch.randn(B, S, cfg.enc_out_dim, generator=g) * 0.5).to(cuda)
    enc_lens = torch.randint(1, S + 1, (B,), generator=g, dtype=torch.int32).to(cuda)
    tf_draws, gumbel = las.draw_scheduled_sampling(L, B, 0.9, cfg, g, device=cuda)
    ids = torch.randint(0, VOCAB_SIZE, (L, B), generator=g).to(cuda)
    with torch.no_grad():
        comp_h = las.attention_precompute(model.attention, enc_h)
        temb = model.embed.weight[ids]
    R = kspell.spell_route(B, cfg.decoder_state_size, cfg.enc_out_dim, cfg.mlp_out_size, S,
                           VOCAB_SIZE)
    return model, (model, enc_h, comp_h, enc_lens, tf_draws, gumbel, temb), R


@pytest.mark.parametrize("route", ["by_shape", "one_row"])
@pytest.mark.parametrize("sizes,B,L,S", SPELL_ROUTE_CASES, ids=SPELL_ROUTE_IDS)
def test_spell_fwd_routes_match_plain(cuda, sizes, B, L, S, route):
    """K9 on the cluster route (the route by shape at every case) and on the
    one-row kernel: the seven streams, and the cluster route's gates, within
    1e-4 of spell_fwd_plain; each launch counted on its route."""
    model, args, R = _spell_case(cuda, sizes, B, L, S, seed=11)
    assert R in kspell.TILE_ROWS
    r = R if route == "by_shape" else 0
    with torch.inference_mode():
        before = dict(kspell.LAUNCHES)
        got = kspell.spell_fwd(*args, with_gates=True, route=r)
        torch.cuda.synchronize()
        assert kspell.LAUNCHES["spell_fwd"] == before["spell_fwd"] + 1
        assert kspell.LAUNCHES["spell_fwd_cluster"] == before["spell_fwd_cluster"] + (r > 0)
        want = kspell.spell_fwd_plain(*args, with_gates=True)
    names = ("logits", "a", "h1s", "c1s", "h2s", "c2s", "fed", "g1s", "g2s")
    assert (got[7] is None) == (r == 0)
    for name, a, b in zip(names, got if r else got[:7], want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0, msg=name)


def _rel_l2(a, ref):
    return float((a.double() - ref).norm() / ref.norm().clamp_min(1e-300))


@pytest.mark.parametrize("route", ["by_shape", "one_row"])
@pytest.mark.parametrize("sizes,B,L,S", [c for c, i in zip(SPELL_ROUTE_CASES, SPELL_ROUTE_IDS)
                                          if i != "detail"],
                         ids=[i for i in SPELL_ROUTE_IDS if i != "detail"])
def test_spell_bwd_routes_match_plain(cuda, sizes, B, L, S, route):
    """K10 on the cluster route (from K9's gates) and on the one-row kernel:
    each stream's relative L2 error against a float64 run of the plain
    version at most 4x the plain float32 version's own, or below 1e-5
    (ROADMAP section 3); each launch counted on its route."""
    from ss_asr_tpu_torch.ops.kernels.decode import speller_weights

    model, args, R = _spell_case(cuda, sizes, B, L, S, seed=12)
    r = R if route == "by_shape" else 0
    enc_h, comp_h = args[1], args[2]
    g = torch.Generator().manual_seed(13)
    dlogits = (torch.randn(L, B, VOCAB_SIZE, generator=g) / B).to(cuda)
    daext = (torch.randn(L, B, S, generator=g) / B).to(cuda)
    W = [w.detach() for w in speller_weights(model)]
    with torch.no_grad():
        out = kspell.spell_fwd(*args, with_gates=True)
        streams, gates = out[1:7], out[7:]
        before = dict(kspell.LAUNCHES)
        got = kspell.spell_bwd(enc_h, comp_h, dlogits, daext, streams, W,
                               gates if r else None, route=r)
        torch.cuda.synchronize()
        assert kspell.LAUNCHES["spell_bwd"] == before["spell_bwd"] + 1
        assert kspell.LAUNCHES["spell_bwd_cluster"] == before["spell_bwd_cluster"] + (r > 0)
        want = kspell.spell_bwd_plain(enc_h, comp_h, dlogits, daext, streams, W)
        ref = kspell.spell_bwd_plain(enc_h.double(), comp_h.double(), dlogits.double(),
                                     daext.double(), tuple(s.double() for s in streams),
                                     [w.double() for w in W])
    for name, a, b, f64 in zip(("dg1", "dg2", "de", "dqp", "demb"), got, want, ref):
        k, p = _rel_l2(a, f64), _rel_l2(b, f64)
        assert k <= 4 * p or k < 1e-5, f"{name}: kernel {k:.3e}, plain float32 {p:.3e}"
    with pytest.raises(ValueError, match="gates"):
        kspell.spell_bwd(enc_h, comp_h, dlogits, daext, streams, W, route=R)


def test_spellcore_takes_the_cluster_route_at_the_flagship(cuda):
    """las.attend_and_spell at the ASR step's shape: K9 writes the gates and
    K10 reads them, both on the cluster route, under SpellCore."""
    model, args, R = _spell_case(cuda, FLAGSHIP, 32, 48, 64, seed=14)
    model.train()
    y = torch.randint(2, VOCAB_SIZE, (32, 49), device=cuda)
    enc_h = args[1].clone().requires_grad_(True)
    before = dict(kspell.LAUNCHES)
    logits, _ = las.attend_and_spell(model, enc_h, args[3], 48, teacher=y, tf_draws=args[4],
                                     gumbel=args[5])
    logits.square().mean().backward()
    torch.cuda.synchronize()
    for name in ("spell_fwd", "spell_fwd_cluster", "spell_bwd", "spell_bwd_cluster"):
        assert kspell.LAUNCHES[name] == before[name] + 1, name
    assert bool(torch.isfinite(enc_h.grad).all())


def _train_step_grads(model, x, x_lens, y, tf_draws, gumbel):
    from ss_asr_tpu_torch.train import losses

    model.zero_grad(set_to_none=True)
    _, logits, _ = las.asr_forward(model, x, x_lens, y.shape[1] - 1, teacher=y,
                                   tf_draws=tf_draws, gumbel=gumbel)
    loss = losses.masked_ce_per_utt(logits, y[:, 1:], y)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


def test_listener_grads_on_the_card_match_the_plain_path(cuda):
    """Every parameter, the listener's included, gets a gradient on the card
    (K2 / K3 under LSTMSeq, K9 / K10 under SpellCore) equal to the CPU's."""
    cfg = las.ASRConfig(encoder_state_size=16, decoder_state_size=16, mlp_out_size=8,
                        feature_dim=5)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 48, 5)).astype(np.float32))
    x_lens = torch.tensor([48, 40, 17, 9], dtype=torch.int32)
    y = torch.from_numpy(rng.integers(2, VOCAB_SIZE, (4, 8))).long()
    y[:, 0] = 0
    tf_draws, gumbel = las.draw_scheduled_sampling(7, 4, 0.5, cfg, torch.Generator().manual_seed(0),
                                                   device="cpu")
    out = []
    for dev in ("cpu", cuda):
        model, _ = _models(cfg, 8, 12, dev)
        out.append(_train_step_grads(model, x.to(dev), x_lens.to(dev), y.to(dev),
                                     tf_draws.to(dev), gumbel.to(dev)))
    (want_loss, want), (got_loss, got) = out
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    for name, g in got.items():
        assert g is not None, name
        torch.testing.assert_close(g.cpu(), want[name], atol=1e-5, rtol=1e-4, msg=name)


def test_asr_trainer_step_on_the_card_matches_the_cpu(cuda, tmp_path):
    from ss_asr_tpu_torch.train.asr_trainer import ASRTrainer
    from ss_asr_tpu_torch.train.solver import make_paras
    from ss_asr_tpu_torch.utils.checkpoint import save_pytree

    mdl = dict(encoder_state_size=16, decoder_state_size=16, mlp_out_size=8, feature_dim=5,
               tf_rate=0.5)
    config = {"asr": {"opt": {"type": "Adadelta", "learning_rate": 1.0}, "mdl": mdl}}
    tree = convert.init_asr_numpy(2, las.ASRConfig(**mdl))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 40, 5)).astype(np.float32))
    x_lens = torch.tensor([40, 31, 22, 9], dtype=torch.int32)
    y = torch.from_numpy(rng.integers(2, VOCAB_SIZE, (4, 9))).long()
    y[:, 0] = 0
    out = []
    for dev in ("cpu", "cuda"):
        save_pytree(str(tmp_path / "result" / dev / "asr.npz"), tree)
        t = ASRTrainer(config, make_paras(name=dev, logdir=str(tmp_path / "runs"),
                                          ckpdir=str(tmp_path / "result"), verbose=False),
                       device=dev)
        t.set_model()
        loss, _ = t.step(x.to(dev), x_lens.to(dev), y.to(dev))
        out.append((float(loss), convert.tree_leaves(t.params_tree())))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-5)
    for a, b in zip(out[1][1], out[0][1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_accumulated_asr_update_on_the_card_matches_the_cpu(cuda, tmp_path):
    """``accum_steps: 2`` with a warm-up / cosine schedule and SpecAugment:
    three calls (one update, then half of the next) on the card and on the
    CPU, each trainer drawing the same augment and scheduled-sampling
    uniforms from its generator: parameters and every optimizer leaf, the
    running mean included, within 1e-5."""
    from ss_asr_tpu_torch.train.asr_trainer import ASRTrainer
    from ss_asr_tpu_torch.train.solver import make_paras
    from ss_asr_tpu_torch.utils.checkpoint import save_pytree

    mdl = dict(encoder_state_size=16, decoder_state_size=16, mlp_out_size=8, feature_dim=5,
               tf_rate=0.5)
    config = {"asr": {"opt": {"type": "Adadelta", "learning_rate": 1.0, "accum_steps": 2,
                              "warmup_steps": 1, "decay_steps": 3, "end_scale": 0.1},
                      "augment": {"n_freq_masks": 1, "freq_mask_width": 2, "n_time_masks": 1,
                                  "time_mask_width": 6},
                      "mdl": mdl}}
    tree = convert.init_asr_numpy(2, las.ASRConfig(**mdl))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 40, 5)).astype(np.float32))
    x_lens = torch.tensor([40, 31, 22, 9], dtype=torch.int32)
    y = torch.from_numpy(rng.integers(2, VOCAB_SIZE, (4, 9))).long()
    y[:, 0] = 0
    out = []
    for dev in ("cpu", "cuda"):
        save_pytree(str(tmp_path / "result" / dev / "asr.npz"), tree)
        t = ASRTrainer(config, make_paras(name=dev, logdir=str(tmp_path / "runs"),
                                          ckpdir=str(tmp_path / "result"), verbose=False),
                       device=dev)
        t.set_model()
        for sl in (slice(0, 2), slice(2, 4), slice(0, 2)):
            t.step(x[sl].to(dev), x_lens[sl].to(dev), y[sl].to(dev))
        assert (t.optim.gradient_step, t.optim.mini_step, t.optim.sched_count) == (1, 1, 1)
        out.append((convert.tree_leaves(t.params_tree()),
                    convert.asr_opt_state_leaves(t.optim, t.model)))
    for a, b in zip(out[1][0], out[0][0]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert len(out[1][1]) == len(out[0][1]) == 5 + 2 * 36 + 1 + 36
    for a, b in zip(out[1][1], out[0][1]):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert float(np.abs(out[1][1][-1]).max()) > 0  # the running mean of the third call


AUX_ASR = dict(encoder_state_size=16, decoder_state_size=16, mlp_out_size=8, feature_dim=8,
               tf_rate=0.5)
AUX_CONFIG = {
    "asr": {"mdl": AUX_ASR},
    "tae": {"opt": {"type": "Adam", "learning_rate": 1e-3},
            "mdl": {"emb_dim": 6, "state_size": 16, "num_layers": 2}},
    "sae": {"opt": {"type": "Adam", "learning_rate": 1e-3}, "listener_lr_scale": 0.5,
            "mdl": {"kernel_sizes": [[1, 5], [5, 1], [3, 1]], "num_filters": [4, 6, 8],
                    "pool_kernel_sizes": [[3, 1], [5, 1], [2000, 40]]}},
    "adv": {"G_opt": {"type": "Adadelta", "learning_rate": 1.0},
            "D_opt": {"type": "Adadelta", "learning_rate": 1.0}, "mdl": {"hidden_dim": 12}},
}


def _aux_three(cls, tmp_path, name, trees):
    """The trainer on the card, on the CPU, and in float64 on the CPU."""
    ts = [aux_trainer(cls, AUX_CONFIG, str(tmp_path), f"{name}_{tag}", trees, dev)
          for tag, dev in (("card", "cuda"), ("cpu", "cpu"), ("f64", "cpu"))]
    for m in ts[2].models.values():
        m.double()
    return ts


def _aux_trees():
    from ss_asr_tpu_torch.models import discriminator as disc_mod
    from ss_asr_tpu_torch.models import speech_autoencoder as sae_mod
    from ss_asr_tpu_torch.models import text_autoencoder as tae_mod

    params, bn = convert.init_sae_numpy(3, sae_mod.SAEConfig.from_dict(
        {**AUX_CONFIG["sae"]["mdl"], "feature_dim": 8, "listener_out_dim": 32}))
    return {"asr": convert.init_asr_numpy(1, las.ASRConfig(**AUX_ASR)),
            "tae": convert.init_tae_numpy(2, tae_mod.TAEConfig(**AUX_CONFIG["tae"]["mdl"])),
            "sae": {"params": params, "bn_state": bn},
            "adv": convert.init_disc_numpy(4, disc_mod.DiscriminatorConfig(in_dim=32,
                                                                           hidden_dim=12))}


def _unchanged_outside(trainer, optims, step):
    """One update: what the optimizers' masks leave out stays bit-equal."""
    from ss_asr_tpu_torch.train.solver import joint_named_parameters

    before = {n: p.detach().clone() for n, p in joint_named_parameters(trainer.models)}
    step()
    trained = set().union(*(o.mask for o in optims))
    moved = {n for n, p in joint_named_parameters(trainer.models) if not torch.equal(before[n], p)}
    assert moved == trained


def _texts(rng, rows, width, short=()):
    y = np.zeros((rows, width), np.int64)
    for i in range(rows):
        k = short[i] if i < len(short) else int(rng.integers(3, width - 1))
        y[i, 1 : k + 1] = rng.integers(3, VOCAB_SIZE, size=k)
        y[i, k + 1] = EOS_ID
    return torch.from_numpy(y), torch.from_numpy((y != 0).sum(-1) + 1)


def test_tae_step_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Noised memories of 1 and 2 characters, S = 11 (no multiple of 8)."""
    from ss_asr_tpu_torch.train.tae_trainer import TAETrainer

    rng = np.random.default_rng(5)
    trees = _aux_trees()
    y, _ = _texts(rng, 5, 11)
    yn, nl = _texts(rng, 5, 11, short=(1, 2))
    ts = _aux_three(TAETrainer, tmp_path, "tae", {k: trees[k] for k in ("asr", "tae")})
    anchored_losses(torch, "TAE step", ts,
                    lambda t, dev: t.loss_of(y.to(dev), yn.to(dev), nl.to(dev))[0])
    before = {k: kernel.LAUNCHES[k] for kernel in (klstm, kspell) for k in kernel.LAUNCHES}
    _unchanged_outside(ts[0], [ts[0].optim], lambda: ts[0].step(y.to(cuda), yn.to(cuda),
                                                                nl.to(cuda)))
    after = {k: kernel.LAUNCHES[k] for kernel in (klstm, kspell) for k in kernel.LAUNCHES}
    assert all(after[k] > before[k] for k in ("lstm_fwd", "lstm_bwd", "spell_fwd", "spell_bwd"))


def test_sae_step_on_the_card_matches_the_cpu(cuda, tmp_path):
    """T = 62 (the listener drops 6 frames; the reconstruction is padded up)."""
    from ss_asr_tpu_torch.train.sae_trainer import SAETrainer

    rng = np.random.default_rng(6)
    trees = _aux_trees()
    x = torch.from_numpy((3.0 * rng.standard_normal((3, 62, 8))).astype(np.float32))
    x_lens = torch.tensor([60, 50, 41], dtype=torch.int32)
    ts = _aux_three(SAETrainer, tmp_path, "sae", {k: trees[k] for k in ("asr", "sae")})
    anchored_losses(torch, "SAE step", ts, lambda t, dev: t.recon_loss(
        x.to(dev).to(next(t.models["sae"].parameters()).dtype), x_lens.to(dev), True)[0],
        pooled=("sae.encoder.",))
    _unchanged_outside(ts[0], [ts[0].optim], lambda: ts[0].step(x.to(cuda), x_lens.to(cuda)))


def test_adv_steps_on_the_card_match_the_cpu(cuda, tmp_path):
    from ss_asr_tpu_torch.train.adv_trainer import ADVTrainer

    rng = np.random.default_rng(7)
    trees = _aux_trees()
    x = torch.from_numpy(rng.standard_normal((3, 32, 8)).astype(np.float32))
    x_lens = torch.tensor([32, 20, 9], dtype=torch.int32)
    y, y_lens = _texts(rng, 3, 9, short=(6, 3, 1))
    ts = _aux_three(ADVTrainer, tmp_path, "adv", {k: trees[k] for k in ("asr", "tae", "adv")})

    def cast(t, dev):
        return x.to(dev).to(next(t.models["disc"].parameters()).dtype)

    anchored_losses(torch, "ADV D-step", ts, lambda t, dev: sum(t.d_losses(
        cast(t, dev), x_lens.to(dev), y.to(dev), y_lens.to(dev), t.label_smoothing)[:2]))
    anchored_losses(torch, "ADV G-step", ts, lambda t, dev: t.g_loss(cast(t, dev), x_lens.to(dev)))
    card = ts[0]
    args = (x.to(cuda), x_lens.to(cuda))
    _unchanged_outside(card, [card.D_optim], lambda: card.d_step(*args, y.to(cuda),
                                                                  y_lens.to(cuda)))
    _unchanged_outside(card, [card.G_optim], lambda: card.g_step(*args))


def test_beam_transcriber_on_the_card_matches_the_cpu(cuda):
    cfg = las.ASRConfig(encoder_state_size=16, decoder_state_size=16, mlp_out_size=8)
    rng = np.random.default_rng(1)
    sigs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (3000, 0, 4500)]
    out = []
    for dev in ("cpu", cuda):
        model, lm = _models(cfg, 8, 5, dev)
        t = Transcriber(model, lm=lm, lm_weight=0.5, beam_size=3, sr=8000, max_steps=12,
                        t_bucket=16)
        fb = [frontend.compute_fbank(s, 8000, device="cpu") for s in sigs[:1]]
        detail = t.transcribe_fbank_detailed(fb, n_best=3)[0]
        out.append((t.transcribe_signal_batch(sigs), [h.text for h in detail],
                    [h.char_frames.tolist() for h in detail]))
    assert out[0] == out[1]


def test_cli_serve_takes_the_default_config_on_the_card(cuda, tmp_path):
    """``python -m ss_asr_tpu_torch.cli.serve`` with conf/default.yaml and an
    LM, no --beam: the server decodes beam 3 + LM 0.5 and answers."""
    from ss_asr_tpu_torch.utils.checkpoint import save_pytree

    root = Path(__file__).resolve().parents[1]
    asr, lm = str(tmp_path / "asr.npz"), str(tmp_path / "lm.npz")
    save_pytree(asr, convert.init_asr_numpy(0, las.ASRConfig()))
    save_pytree(lm, convert.init_charlm_numpy(1, charlm.CharLMConfig()))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "ss_asr_tpu_torch.cli.serve", asr, "--config",
         str(root / "conf" / "default.yaml"), "--lm", lm, "--port", str(port)],
        cwd=root, env={**os.environ, "PYTHONPATH": str(root)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        assert "serving on" in proc.stdout.readline()
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(22050)
            y = 0.1 * np.random.default_rng(0).standard_normal(33075)
            w.writeframes((y * 32767).astype(np.int16).tobytes())
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        url = f"http://127.0.0.1:{port}/transcribe?detail=1&nbest=3"
        reply = None
        for _ in range(50):  # the socket opens just after the banner
            try:
                with opener.open(urllib.request.Request(url, data=buf.getvalue()),
                                 timeout=120) as r:
                    reply = json.load(r)
                break
            except OSError:
                time.sleep(0.2)
        assert reply is not None and len(reply["hypotheses"]) == 3
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# --------------------------------------------------------------------------
# the char-LM trainer, the tester and pseudo-labels on the card


def test_lm_step_on_the_card_matches_float64(cuda, tmp_path):
    """One char-LM step (B = 6, L = 23, H = 24, tf 0.7, draws from one seeded
    generator) by the anchored rule; then an update moves every parameter."""
    from ss_asr_tpu_torch.train.lm_trainer import CHARLMTrainer
    from ss_asr_tpu_torch.train.solver import make_paras
    from ss_asr_tpu_torch.utils.checkpoint import save_pytree

    corpus = tmp_path / "lm.txt"
    corpus.write_text("aba fig dig hide jade echo " * 40)
    config = {"char_lm": {"opt": {"type": "Adam", "learning_rate": 1e-3},
                          "mdl": {"hidden_size": 24, "tf_rate": 0.7}, "train_index": str(corpus),
                          "chunk_size": 23, "train_batch_size": 6}}
    tree = convert.init_charlm_numpy(3, charlm.CharLMConfig(hidden_size=24))
    ts = []
    for tag, dev in (("card", "cuda"), ("cpu", "cpu"), ("f64", "cpu")):
        save_pytree(str(tmp_path / "result" / tag / "char_lm.npz"), tree)
        t = CHARLMTrainer(config, make_paras(tag, str(tmp_path / "runs"),
                                             str(tmp_path / "result"), 1, False), device=dev)
        t.load_data()
        t.set_model()
        ts.append(t)
    ts[2].lm.double()
    y = torch.from_numpy(next(ts[1].ds.iter_batches(6, seed=0))[1]).long()
    draws = las.draw_scheduled_sampling(23, 6, 0.7, ts[0].cfg, torch.Generator().manual_seed(2),
                                        device="cpu")
    anchored_losses(torch, "char-LM step", ts, lambda t, dev: t.loss_of(
        y.to(dev), draws[0].to(dev), draws[1].to(dev).to(t.lm.out.weight.dtype))[0])
    _unchanged_outside(ts[0], [ts[0].optim], lambda: ts[0].step(y.to(cuda)))


def _tester_setup(tmp_path):
    """A tone corpus's fbanks (cli.mkdata + the frontend on the card), a
    seeded ASR checkpoint of H = 64 that does not stop early and a char-LM
    beside it, and a config."""
    from ss_asr_tpu_torch.cli import mkdata
    from ss_asr_tpu_torch.data.audio import load_wav
    from ss_asr_tpu_torch.utils.checkpoint import save_pytree
    from ss_asr_tpu_torch.vocab import normalize_string

    mkdata.make_corpus(str(tmp_path / "corpus"), n=7, seed=1)
    rows = []
    for i in range(7):
        _, y = load_wav(str(tmp_path / "corpus" / "wav" / f"u{i:04d}.wav"), target_sr=16000)
        fb = frontend.compute_fbank(y, 16000, device="cuda")
        path = str(tmp_path / f"u{i}.npy")
        np.save(path, fb)
        text = (tmp_path / "corpus" / "txt" / f"u{i:04d}.txt").read_text()
        norm, s_len = normalize_string(text)
        rows.append((norm, path, s_len, fb.shape[0], "na", f"u{i}.wav"))
    idx = tmp_path / "index.tsv"
    idx.write_text("".join("\t".join(map(str, r)) + "\n" for r in sorted(rows, key=lambda r: r[3])))
    mdl = {"encoder_state_size": 64, "decoder_state_size": 64, "mlp_out_size": 32}
    d = tmp_path / "result" / "test"
    tree = convert.init_asr_numpy(4, las.ASRConfig(**mdl))
    tree["char_trans"]["b"][1] = -5.0  # no early EOS: every hypothesis has characters to align
    save_pytree(str(d / "asr.npz"), tree)
    save_pytree(str(d / "char_lm.npz"), convert.init_charlm_numpy(5, charlm.CharLMConfig()))
    return {"asr": {"mdl": mdl, "test_index": str(idx), "test_batch_size": 3,
                    "max_decode_step_ratio": 0.25, "decode_lm_weight": 0.5},
            "char_lm": {"mdl": {"hidden_size": 128}}}


@pytest.mark.parametrize("beam", [1, 3], ids=["greedy+lm", "beam3+lm"])
def test_asr_tester_on_the_card_equals_the_direct_decodes(cuda, tmp_path, beam):
    """``cli.train ASRTester`` on the card: its launches (K2, and K7 or K8
    with the LM) counted, and its transcripts those of the direct decode
    calls on the same batches, which equal the CPU tester's."""
    from ss_asr_tpu_torch.cli import train
    from ss_asr_tpu_torch.data.asr_dataset import ASRDataset, round_up
    from ss_asr_tpu_torch.decode.beam import beam_decode
    from ss_asr_tpu_torch.decode.greedy import greedy_decode_early_exit
    from ss_asr_tpu_torch.train.solver import make_paras
    from ss_asr_tpu_torch.train.tester import ASRTester

    config = _tester_setup(tmp_path)
    config["asr"]["decode_beam_size"] = beam
    path = tmp_path / "conf.yaml"
    path.write_text(json.dumps(config))
    counters = (klstm.LAUNCHES, kdec.LAUNCHES, kbeam.LAUNCHES)
    before = {k: c[k] for c in counters for k in c}
    train.main(["ASRTester", "test", str(path), str(tmp_path / "runs"), str(tmp_path / "result"),
                "--verbose", "0"])
    launched = {k: c[k] - before[k] for c in counters for k in c}
    need = "greedy_decode_lm" if beam == 1 else "beam_decode_lm"
    assert launched["lstm_fwd"] > 0 and launched[need] > 0
    fname = f"decode_beam_{beam}_len_0.25_lm0.5.txt"
    got = [line.split("\t")[0] for line in
           (tmp_path / "result" / "test" / fname).read_text(encoding="utf-8").splitlines()]

    t = ASRTester(config, make_paras("test", str(tmp_path / "runs"), str(tmp_path / "result"), 1,
                                     False), device="cuda")
    t.load_data()
    t.set_model()
    want = []
    for b in ASRDataset(config["asr"]["test_index"], batch_size=3).iter_batches(drop_last=False):
        ms = min(200, max(8, round_up(int(0.25 * b.x.shape[1]), 8)))
        x, lens = torch.from_numpy(b.x).to(cuda), torch.from_numpy(b.x_lens).to(cuda)
        if beam > 1:
            toks, _ = beam_decode(t.model, x, lens, beam, ms, t.lm, 0.5)
        else:
            with torch.inference_mode():
                toks = greedy_decode_early_exit(t.model, x, lens, ms, t.lm, 0.5)[0].cpu().numpy()
        want += [t.mapper.translate(toks[i]) for i in range(len(toks))
                 if b.valid is None or b.valid[i]]
    assert got == want and len(got) == 7
    cpu = ASRTester(config, make_paras("test", str(tmp_path / "runs"), str(tmp_path / "result"),
                                       1, False), device="cpu")
    cpu.load_data()
    cpu.set_model()
    assert cpu.exec() == got


def test_pseudolabel_on_the_card(cuda, tmp_path):
    """``cli.pseudolabel`` (beam 3 + LM) on the card: K11, K2, K8 and K9
    launch, and its summary and kept texts are the CPU run's."""
    from ss_asr_tpu_torch.cli import pseudolabel

    config = _tester_setup(tmp_path)
    config["asr"]["decode_beam_size"] = 3
    path = tmp_path / "conf.yaml"
    path.write_text(json.dumps(config))
    wavs = [str(tmp_path / "corpus" / "wav" / f"u{i:04d}.wav") for i in range(7)]
    argv = [str(tmp_path / "result" / "test" / "asr.npz"), None, *wavs, "--config", str(path),
            "--lm", str(tmp_path / "result" / "test" / "char_lm.npz"), "--sr", "16000",
            "--batch", "4", "--min-avg-logprob", "-1000", "--min-chars", "0",
            "--max-steps", "24"]
    counters = (klstm.LAUNCHES, kbeam.LAUNCHES, kspell.LAUNCHES, kfe.LAUNCHES)
    out = {}
    for dev in ("cuda", "cpu"):
        argv[1] = str(tmp_path / f"pseudo_{dev}")
        before = {k: c[k] for c in counters for k in c}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert pseudolabel.main([*argv, "--device", dev]) == 0
        launched = {k: c[k] - before[k] for c in counters for k in c}
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        summary.pop("index")
        texts = [line.split("\t")[0] for line in
                 (Path(argv[1]) / "index.tsv").read_text(encoding="utf-8").splitlines()]
        out[dev] = (summary, texts)
        if dev == "cuda":
            assert all(launched[k] > 0 for k in ("fbank", "lstm_fwd", "beam_decode_lm",
                                                  "spell_fwd")), launched
        else:
            assert not any(launched.values())
    assert out["cuda"][1] == out["cpu"][1] and out["cuda"][0]["n_kept"] == 7
    assert all(len(t) > 2 for t in out["cuda"][1])  # "<" + characters + ">"
    assert out["cuda"][0]["rejected_low_conf"] == out["cpu"][0]["rejected_low_conf"] == 0


# --------------------------------------------------------------------------
# data parallelism and mesh serving on the card


def test_dp_step_on_the_card_matches_one_process(cuda, tmp_path):
    """Two ranks sharing the card under gloo (tests/torch_dp_workers.py)
    against one process on the joined batch, tf 0.9 (the global batch's
    draws): losses and parameters within 1e-5 relative, the ranks
    bit-equal, every rank launching K2, K3, K9 and K10."""
    import torch_dp_workers as workers

    mdl = {"encoder_state_size": 32, "mlp_out_size": 16, "decoder_state_size": 32,
           "tf_rate": 0.9, "feature_dim": 8}
    config = {"asr": {"opt": {"type": "Adadelta", "learning_rate": 1.0}, "mdl": mdl}}
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(2):
        x = (0.5 * rng.standard_normal((8, 32, 8))).astype(np.float32)
        xl = rng.integers(16, 33, size=8).astype(np.int32)
        y = np.zeros((8, 9), np.int64)
        for i, k in enumerate(rng.integers(2, 8, size=8)):
            y[i, 1:k + 1] = rng.integers(3, VOCAB_SIZE, size=k)
            y[i, k + 1] = EOS_ID
        batches.append((x, xl, y))
    tree = convert.init_asr_numpy(3, las.ASRConfig(**mdl))
    from ss_asr_tpu_torch.train.asr_trainer import ASRTrainer
    from ss_asr_tpu_torch.train.solver import make_paras
    from ss_asr_tpu_torch.utils.checkpoint import save_pytree

    for name in ("dp", "one"):
        save_pytree(str(tmp_path / "result" / name / "asr.npz"), tree)
    r0, r1 = workers.run_ranks(workers.asr_steps, 2, tmp_path / "ranks",
                               [({**config, "parallel": {"n_data": "auto"}}, str(tmp_path), "dp",
                                 batches)], device="cuda")
    t = ASRTrainer(config, make_paras("one", str(tmp_path / "runs"), str(tmp_path / "result"), 1,
                                      False), device="cuda")
    t.set_model()
    losses = [float(t.step(*(torch.from_numpy(a).to(cuda) for a in b))[0]) for b in batches]
    (l0, tree0, opt0, launched), (l1, tree1, opt1, _) = r0[0], r1[0]
    assert l0 == l1
    for a, b in zip(convert.tree_leaves(tree0) + opt0, convert.tree_leaves(tree1) + opt1):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(l0, losses, rtol=1e-5)
    for a, b in zip(convert.tree_leaves(tree0), convert.tree_leaves(t.params_tree())):
        err = np.abs(a.astype(np.float64) - b).max(initial=0.0)
        assert err <= 1e-7 or np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b)
    assert all(launched[k] >= 2 for k in ("lstm_fwd", "lstm_bwd", "spell_fwd", "spell_bwd"))


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_tp_step_on_the_card_matches_one_process(cuda, tmp_path, mesh):
    """Tensor parallelism at (data, model) = ``mesh``, the ranks on the
    cards (sharing one under gloo; one a card under NCCL where there are
    enough; tests/torch_tp_workers.py), against one process on the joined
    batches, tf 0.9: losses and gathered parameters within 1e-5 relative,
    the ranks' gathered trees bit-equal, every rank launching K2, K3, K9
    and K10 on the gathered weights."""
    import torch_dp_workers as workers
    import torch_tp_workers as tp_workers

    mdl = {"encoder_state_size": 32, "mlp_out_size": 16, "decoder_state_size": 32,
           "tf_rate": 0.9, "feature_dim": 8}
    config = {"asr": {"opt": {"type": "Adadelta", "learning_rate": 1.0}, "mdl": mdl}}
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(2):
        x = (0.5 * rng.standard_normal((8, 32, 8))).astype(np.float32)
        xl = rng.integers(16, 33, size=8).astype(np.int32)
        y = np.zeros((8, 9), np.int64)
        for i, k in enumerate(rng.integers(2, 8, size=8)):
            y[i, 1:k + 1] = rng.integers(3, VOCAB_SIZE, size=k)
            y[i, k + 1] = EOS_ID
        batches.append((x, xl, y))
    tree = convert.init_asr_numpy(3, las.ASRConfig(**mdl))
    from ss_asr_tpu_torch.train.asr_trainer import ASRTrainer
    from ss_asr_tpu_torch.train.solver import make_paras
    from ss_asr_tpu_torch.utils.checkpoint import save_pytree

    for name in ("tp", "one"):
        save_pytree(str(tmp_path / "result" / name / "asr.npz"), tree)
    D, M = mesh
    ranks = workers.run_ranks(tp_workers.tp_steps, D * M, tmp_path / "ranks",
                              [({**config, "parallel": {"n_data": D, "n_model": M}},
                                str(tmp_path), "tp", batches)], device="cuda")
    t = ASRTrainer(config, make_paras("one", str(tmp_path / "runs"), str(tmp_path / "result"), 1,
                                      False), device="cuda")
    t.set_model()
    losses = [float(t.step(*(torch.from_numpy(a).to(cuda) for a in b))[0]) for b in batches]
    rs = [r[0] for r in ranks]
    r0 = rs[0]
    for r in rs[1:]:
        assert r["losses"] == r0["losses"]
        for a, b in zip(convert.tree_leaves(r0["tree"]) + r0["opt"],
                        convert.tree_leaves(r["tree"]) + r["opt"]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    for a, b in zip(convert.tree_leaves(r0["tree"]), convert.tree_leaves(t.params_tree())):
        err = np.abs(a.astype(np.float64) - b).max(initial=0.0)
        assert err <= 1e-7 or np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b)
    for r in rs:
        assert all(r["launches"][k] >= 2 for k in ("lstm_fwd", "lstm_bwd", "spell_fwd",
                                                   "spell_bwd"))
        assert r["shards"] and r["bytes"]["gather"] > 0
    # a card a rank (NCCL) where the machine has enough, else all on one (gloo)
    own = torch.cuda.device_count() >= D * M
    assert [r["backend"] for r in rs] == ["nccl" if own else "gloo"] * (D * M)
    assert [r["device"] for r in rs] == [f"cuda:{i if own else 0}" for i in range(D * M)]


@pytest.mark.parametrize("kw,kernel", [({"beam_size": 1}, "greedy_decode"),
                                       ({"beam_size": 1, "lm_weight": 0.5}, "greedy_decode_lm"),
                                       ({"beam_size": 3, "lm_weight": 0.5}, "beam_decode_lm")],
                         ids=["greedy", "greedy+lm", "beam3+lm"])
def test_mesh_transcriber_on_the_card_matches_one_device(cuda, kw, kernel):
    """``Transcriber(mesh=)`` over [cuda, cuda] against the single device,
    by the smoke's near-tie rule (``chip_smoke.mesh_matches_single``), each
    shard launching its decode kernel."""
    import chip_smoke
    from ss_asr_tpu_torch.parallel.mesh import make_mesh

    cfg = las.ASRConfig(encoder_state_size=32, decoder_state_size=32, mlp_out_size=16)
    model, lm = _models(cfg, 16, 11, cuda)
    lm = lm if kw.get("lm_weight") else None
    rng = np.random.default_rng(3)
    sigs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (9000, 0, 22050, 15000, 4000)]
    single = Transcriber(model, lm=lm, max_steps=chip_smoke.MAX_STEPS, sr=chip_smoke.SR, **kw)
    meshed = Transcriber(model, lm=lm, max_steps=chip_smoke.MAX_STEPS, sr=chip_smoke.SR,
                         mesh=make_mesh(devices=["cuda", "cuda"]), **kw)
    before = kdec.LAUNCHES[kernel] if "greedy" in kernel else kbeam.LAUNCHES[kernel]
    assert chip_smoke.mesh_matches_single(torch, kernel, single, meshed, sigs) <= 2
    after = kdec.LAUNCHES[kernel] if "greedy" in kernel else kbeam.LAUNCHES[kernel]
    assert after - before >= 3  # one for the single batch, one for each of the two shards
