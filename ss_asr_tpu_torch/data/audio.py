"""WAV reading and resampling (numpy / scipy / stdlib only).

Copied from ``ss_asr_tpu/data/audio.py``: ``read_wav`` parses with scipy's
reader (stdlib ``wave`` as the fallback) into float32 mono in [-1, 1],
``resample`` is scipy's polyphase filter with a linear-interpolation
fallback, and ``load_wav`` is the two together.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

DEFAULT_SR = 22050  # librosa.load's default, for strict reference parity


def read_wav(path) -> Tuple[int, np.ndarray]:
    """Read a WAV file (path or file object) -> (sample_rate, float32 mono)."""
    try:
        from scipy.io import wavfile

        sr, data = wavfile.read(path)
    except Exception:
        import wave

        if hasattr(path, "seek"):
            path.seek(0)
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            raw = w.readframes(w.getnframes())
            dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[w.getsampwidth()]
            data = np.frombuffer(raw, dtype=dtype)
            if w.getnchannels() > 1:
                data = data.reshape(-1, w.getnchannels())

    data = np.asarray(data)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    elif np.issubdtype(data.dtype, np.integer):
        data = data.astype(np.float32) / float(np.iinfo(data.dtype).max)
    else:
        data = data.astype(np.float32)
    return int(sr), data


def resample(y: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample (scipy) with a linear-interp fallback."""
    if sr == target_sr:
        return y
    try:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(sr, target_sr)
        return resample_poly(y, target_sr // g, sr // g).astype(np.float32)
    except ImportError:
        n_out = int(round(len(y) * target_sr / sr))
        xp = np.linspace(0.0, 1.0, len(y), endpoint=False)
        xq = np.linspace(0.0, 1.0, n_out, endpoint=False)
        return np.interp(xq, xp, y).astype(np.float32)


def load_wav(path: str, target_sr: Optional[int] = DEFAULT_SR) -> Tuple[int, np.ndarray]:
    """Read + optionally resample; returns (sr, signal)."""
    sr, y = read_wav(path)
    if target_sr is not None and sr != target_sr:
        y = resample(y, sr, target_sr)
        sr = target_sr
    return sr, y
