"""Log-mel filterbank frontend on tensors.

Port of ``ss_asr_tpu/ops/frontend.py`` (``log_mel_fbank_batch``, its core
``_log_mel_fbank_batch``, ``log_mel_fbank_ragged`` and ``compute_fbank``);
the numpy constants (``mel_filterbank``, ``_windowed_dft_basis``,
``frame_params``, ``num_frames``, ``LOG_EPS``) are copied from it.

40-band Slaney mel spectrogram with a 25 ms periodic Hann window and 10 ms
stride, ``center=True`` reflect padding, power 2, natural
``log(x + float64_eps)`` — librosa 0.6 ``melspectrogram`` semantics.  The
DFT and mel projections are two ``torch.matmul``s, as JAX computes them
outside any kernel on its main path (its Pallas frontend is opt-in).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

N_DIMS = 40  # mel bands
WIN_MS = 25  # window length in ms
STRIDE_MS = 10  # hop in ms
#: log floor — float64 machine eps, as in the reference's np.finfo(float).eps
LOG_EPS = float(np.finfo(np.float64).eps)


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    return np.where(log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = m >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(
    sr: int, n_fft: int, n_mels: int = N_DIMS, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """Slaney-style area-normalized mel filter matrix ``[n_bins, n_mels]``."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts.reshape(-1, 1) - fftfreqs.reshape(1, -1)
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm.reshape(-1, 1)
    return weights.T.astype(np.float32)


def _hann_periodic(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def _dft_basis(n_fft: int) -> np.ndarray:
    """Real-DFT basis ``[n_fft, 2 * n_bins]`` = [cos | -sin] columns."""
    n_bins = 1 + n_fft // 2
    t = np.arange(n_fft).reshape(-1, 1)
    k = np.arange(n_bins).reshape(1, -1)
    ang = 2.0 * np.pi * t * k / n_fft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _windowed_dft_basis(n_fft: int) -> np.ndarray:
    """Window·DFT fused into one ``[n_fft, 2*n_bins]`` projection matrix."""
    return (_hann_periodic(n_fft)[:, None] * _dft_basis(n_fft)).astype(np.float32)


def frame_params(sr: int, win_ms: int = WIN_MS, stride_ms: int = STRIDE_MS) -> Tuple[int, int]:
    """(n_fft, hop) in samples for a sample rate — int truncation as reference."""
    return int(sr * 0.001 * win_ms), int(sr * 0.001 * stride_ms)


def num_frames(n_samples, n_fft: int, hop: int):
    """Frame count of a centered STFT: ``1 + (n + 2*(n_fft//2) - n_fft) // hop``."""
    return 1 + (n_samples + 2 * (n_fft // 2) - n_fft) // hop


@functools.lru_cache(maxsize=16)
def _projections(sr: int, n_mels: int, win_ms: int, stride_ms: int, device: torch.device):
    n_fft, _ = frame_params(sr, win_ms, stride_ms)
    wbasis = torch.from_numpy(_windowed_dft_basis(n_fft)).to(device)
    mel = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels)).to(device)
    return wbasis, mel


def _reflect(idx: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """numpy 'reflect' index map for any coordinate (period 2(n-1)
    triangle), so signals shorter than the pad width bounce as np.pad does."""
    period = torch.clamp(2 * n - 2, min=1)
    m = torch.remainder(idx, period)
    return torch.minimum(torch.where(m < n, m, period - m), n - 1).clamp(min=0)


def log_mel_fbank_batch(
    y: torch.Tensor,
    n_samples: Optional[torch.Tensor],
    sr: int,
    n_mels: int = N_DIMS,
    win_ms: int = WIN_MS,
    stride_ms: int = STRIDE_MS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched frontend over zero-padded signal buffers.

    Args:
      y: ``[B, N]`` signals, zero-padded to a common N.
      n_samples: ``[B]`` true sample counts, or None when every row fills
        the buffer.

    Returns ``(fbanks [B, T, n_mels], frame_lens [B])``, T the frame count
    of the full buffer, frames past ``frame_lens[b]`` zeroed.  Every valid
    frame equals the frontend of the row's own true-length signal: each row
    is reflect-padded at its OWN start and end, which one gather does here
    (JAX patches a buffer-level pad; the frames that differ are masked).
    """
    n_fft, hop = frame_params(sr, win_ms, stride_ms)
    pad = n_fft // 2
    y = y.to(torch.float32)
    B, N = y.shape
    dev = y.device
    c = torch.arange(-pad, N + pad, device=dev)[None, :]  # signal coordinate
    if n_samples is None:
        idx = _reflect(c, torch.full((B, 1), N, device=dev)).expand(B, -1)
    else:
        ns = torch.clamp(n_samples.to(device=dev, dtype=torch.int64), min=1)[:, None]
        # before the start and at/after the end: the row's own reflection;
        # coordinates past ns + pad only reach masked frames
        idx = torch.where((c >= 0) & (c < ns), c, _reflect(c, ns))
    yp = torch.gather(y, 1, idx)
    nf = int(num_frames(N, n_fft, hop))
    frames = yp.unfold(1, n_fft, hop)[:, :nf]  # [B, nf, n_fft]
    wbasis, mel = _projections(sr, n_mels, win_ms, stride_ms, dev)
    spec = torch.matmul(frames, wbasis)
    n_bins = 1 + n_fft // 2
    power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    fb = torch.log(torch.matmul(power, mel) + LOG_EPS)
    if n_samples is None:
        return fb, torch.full((B,), nf, dtype=torch.int32, device=dev)
    frame_lens = num_frames(n_samples.to(device=dev, dtype=torch.int64), n_fft, hop).to(torch.int32)
    mask = torch.arange(nf, device=dev)[None, :] < frame_lens[:, None]
    return torch.where(mask[:, :, None], fb, torch.zeros((), device=dev)), frame_lens


def compute_fbank(y: np.ndarray, sr: int, n_mels: int = N_DIMS, device="cpu") -> np.ndarray:
    """One signal -> ``[T, n_mels]`` float32 numpy array."""
    buf = torch.as_tensor(np.asarray(y, np.float32).reshape(1, -1), device=device)
    fb, _ = log_mel_fbank_batch(buf, None, sr, n_mels)
    return fb[0].cpu().numpy()


def log_mel_fbank_ragged(
    sigs: Sequence[np.ndarray], sr: int, n_mels: int = N_DIMS, min_rows: int = 1, device="cpu"
) -> List[np.ndarray]:
    """Frontend over a ragged list of signals, padded into one buffer on a
    half-second grid with at least ``min_rows`` rows (padded rows carry one
    sample; their output is dropped).  Returns ``[T_i, n_mels]`` arrays."""
    if not sigs:
        return []
    step = max(sr // 2, 1)
    bucket = -(-max(len(s) for s in sigs) // step) * step
    nrows = max(len(sigs), min_rows)
    buf = np.zeros((nrows, bucket), np.float32)
    ns = np.ones((nrows,), np.int64)
    for r, s in enumerate(sigs):
        buf[r, : len(s)] = s
        ns[r] = len(s)
    fb, fl = log_mel_fbank_batch(torch.as_tensor(buf, device=device),
                                 torch.as_tensor(ns, device=device), sr, n_mels)
    fb, fl = fb.cpu().numpy(), fl.cpu().numpy()
    return [fb[r, : fl[r]] for r in range(len(sigs))]
