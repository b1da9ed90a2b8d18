"""The port's batched log-mel frontend against the JAX one.

Tolerance: 1e-4 absolute in the log-mel domain, for every mel energy above
a floor 60 dB under its frame's peak.  Both packages run the same float32
DFT and mel products (JAX's ``precision=HIGH`` is full float32 on the CPU)
but sum in different orders; the log turns the relative error of an energy
into an absolute one.  Far below a frame's peak the energy is float32
rounding noise of the DFT (about 1e-11 of the peak, e.g. the high bands of
the constant frames that a one-sample signal reflects into), where the two
orders give different noise; there both values must merely stay under the
floor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss_asr_tpu.ops import frontend as jfe
from ss_asr_tpu_torch.ops import frontend as fe

torch.set_num_threads(1)

ATOL = 1e-4
FLOOR_DB = 60.0


def assert_logmel_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    floor = want.max(axis=-1, keepdims=True) - FLOOR_DB * np.log(10) / 10
    above = want > floor
    np.testing.assert_allclose(got[above], want[above], atol=ATOL, rtol=0)
    assert np.all(got[~above] < floor.repeat(got.shape[-1], -1)[~above] + 1.0)


def _ragged(rng, sr, lens):
    pad = fe.frame_params(sr)[0] // 2
    lens = [pad + 37 if n is None else n for n in lens]
    N = max(lens)
    buf = np.zeros((len(lens), N), np.float32)
    for i, n in enumerate(lens):
        buf[i, :n] = 0.3 * rng.standard_normal(n)
    return buf, np.asarray(lens, np.int32), pad


@pytest.mark.parametrize("sr", [8000, 16000, 22050])
def test_batch_matches_jax_on_ragged_rows(rng, sr):
    # a full row, a row shorter than the pad width, a row of one sample,
    # an empty row, and one just past the pad width
    pad = fe.frame_params(sr)[0] // 2
    buf, lens, _ = _ragged(rng, sr, [sr // 2 + 13, pad // 3, 1, 0, None])
    assert lens[1] < pad
    want, wl = jfe.log_mel_fbank_batch(jnp.asarray(buf), jnp.asarray(lens), sr)
    got, gl = fe.log_mel_fbank_batch(torch.from_numpy(buf), torch.from_numpy(lens), sr)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert_logmel_close(got.numpy(), want)
    # frames past each row's length are exactly zero
    for b, n in enumerate(gl.numpy()):
        assert np.all(got.numpy()[b, n:] == 0.0)


def test_full_buffer_rows_without_lengths(rng):
    sr = 16000
    buf = (0.3 * rng.standard_normal((3, 4000))).astype(np.float32)
    want, wl = jfe.log_mel_fbank_batch(jnp.asarray(buf), None, sr)
    got, gl = fe.log_mel_fbank_batch(torch.from_numpy(buf), None, sr)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert_logmel_close(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 50, 3001])
def test_compute_fbank_matches_jax(rng, n):
    y = (0.3 * rng.standard_normal(n)).astype(np.float32)
    want = jfe.compute_fbank(y, 16000)
    got = fe.compute_fbank(y, 16000)
    assert_logmel_close(got, want)


def test_ragged_helper_matches_jax(rng):
    sigs = [(0.3 * rng.standard_normal(n)).astype(np.float32) for n in (900, 4100, 2)]
    want = jfe.log_mel_fbank_ragged(sigs, 8000, min_rows=4)
    got = fe.log_mel_fbank_ragged(sigs, 8000, min_rows=4)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_logmel_close(g, w)


def test_numpy_constants_equal_jax():
    for sr in (8000, 22050):
        n_fft, _ = fe.frame_params(sr)
        assert fe.frame_params(sr) == jfe.frame_params(sr)
        np.testing.assert_array_equal(fe.mel_filterbank(sr, n_fft), jfe.mel_filterbank(sr, n_fft))
        np.testing.assert_array_equal(fe._windowed_dft_basis(n_fft), jfe._windowed_dft_basis(n_fft))
    assert fe.LOG_EPS == jfe.LOG_EPS
