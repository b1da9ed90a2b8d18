"""The frontend kernel's plain version against the JAX package's fused
Pallas kernel (interpret mode, as the JAX package's own tests run it) and
its XLA matmul pipeline.

Tolerance, as ``tests/test_torch_frontend.py`` states it: 1e-4 absolute in
the log-mel domain for every energy within 60 dB of its frame's peak (the
packages sum the same float32 products in different orders; the log turns a
relative error of an energy into an absolute one), and the entries below that
floor must stay below it.  On white noise, where every band carries energy,
that is 1e-4 everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss_asr_tpu.ops import frontend as jfe
from ss_asr_tpu.ops.pallas import frontend as jpfe
from ss_asr_tpu_torch.ops import frontend as fe
from ss_asr_tpu_torch.ops.kernels import frontend as kfe
from test_torch_frontend import ATOL, assert_logmel_close

torch.set_num_threads(1)


def _ragged(rng, sr):
    """A full row, a short one, one shorter than the pad width, one sample."""
    pad = fe.frame_params(sr)[0] // 2
    lens = np.array([sr // 2 + 13, sr // 5, pad // 3, 1], np.int32)
    buf = np.zeros((len(lens), int(lens.max())), np.float32)
    for i, n in enumerate(lens):
        buf[i, :n] = 0.3 * rng.standard_normal(n)
    return buf, lens


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("sr", [8000, 16000, 22050])
def test_batch_frontend_matches_the_jax_kernel_and_pipeline(rng, sr, impl):
    buf, lens = _ragged(rng, sr)
    want, wl = jfe._log_mel_fbank_batch(jnp.asarray(buf), jnp.asarray(lens), sr, 40, 25, 10, impl,
                                        impl == "pallas")
    got, gl = fe.log_mel_fbank_batch(torch.from_numpy(buf), torch.from_numpy(lens), sr)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert_logmel_close(got.numpy(), np.asarray(want))
    # the full row is white noise: every band within the plain tolerance
    n = int(gl[0])
    np.testing.assert_allclose(got.numpy()[0, :n], np.asarray(want)[0, :n], rtol=0, atol=ATOL)


@pytest.mark.parametrize("nf", [5, 600], ids=["below one tile", "above one tile"])
def test_fbank_plain_matches_fbank_pallas_on_the_same_padded_signal(rng, nf):
    """The two kernels' own contract: a padded signal in, nf frames out
    (the Pallas kernel walks 512-frame cells, so 600 frames cross one)."""
    sr = 16000
    n_fft, hop = fe.frame_params(sr)
    yp = (0.3 * rng.standard_normal((2, (nf - 1) * hop + n_fft + 7))).astype(np.float32)
    wbasis, mel = fe._windowed_dft_basis(n_fft), np.ascontiguousarray(fe.mel_filterbank(sr, n_fft))
    want = jpfe.fbank_pallas(jnp.asarray(yp), jnp.asarray(wbasis), jnp.asarray(mel), nf, n_fft,
                             hop, interpret=True)
    got = kfe.fbank_plain(torch.from_numpy(yp), torch.from_numpy(wbasis), torch.from_numpy(mel),
                          nf, n_fft, hop)
    assert got.shape == (2, nf, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    # the wrapper takes the plain version for a CPU tensor, and counts no launch
    before = dict(kfe.LAUNCHES)
    routed = kfe.fbank(torch.from_numpy(yp), torch.from_numpy(wbasis), torch.from_numpy(mel), nf,
                       n_fft, hop)
    assert torch.equal(routed, got) and kfe.LAUNCHES == before


def test_interleaved_basis_layout():
    wb = torch.arange(3 * 6, dtype=torch.float32).reshape(3, 6)  # 3 bins: cos 0-2 | -sin 3-5
    il = kfe.interleave_basis(wb)
    assert il.shape == (kfe.K_STEP, kfe.COL_CHUNK) and il.is_contiguous()
    np.testing.assert_array_equal(il[0, :8].numpy(), [0, 3, 1, 4, 2, 5, 0, 0])
    assert not il[3:].any() and not il[:, 6:].any()
    for sr in (8000, 16000, 22050):
        n_fft, _ = fe.frame_params(sr)
        full = kfe.interleave_basis(torch.from_numpy(fe._windowed_dft_basis(n_fft)))
        assert full.shape[1] % kfe.COL_CHUNK == 0 and full.shape[1] >= 2 * (1 + n_fft // 2)
        assert full.shape[0] % kfe.K_STEP == 0 and n_fft <= full.shape[0] < n_fft + kfe.K_STEP


def test_fbank_refuses_shapes_that_do_not_fit():
    n_fft, hop = fe.frame_params(8000)
    wbasis, mel, _ = fe._projections(8000, 40, 25, 10, torch.device("cpu"))
    with pytest.raises(ValueError, match="do not fit"):
        kfe.fbank(torch.zeros(1, n_fft + hop - 1), wbasis, mel, 2, n_fft, hop)
    with pytest.raises(ValueError, match="do not fit"):
        kfe.fbank(torch.zeros(1, 4 * n_fft), wbasis[:-1], mel, 2, n_fft, hop)
    assert kfe.fbank(torch.zeros(1, n_fft + hop), wbasis, mel, 2, n_fft, hop).shape == (1, 2, 40)


@pytest.mark.parametrize("sr,n,chunk", [(16000, 40000, 3000), (22050, 30000, 16000),
                                        (8000, 90, 40)])
def test_streaming_frontend_equals_the_one_shot_and_jax(rng, sr, n, chunk):
    y = (0.3 * rng.standard_normal(n)).astype(np.float32)
    sfe, jsfe = fe.StreamingFrontend(sr, device="cpu"), jfe.StreamingFrontend(sr)
    got, want = [], []
    for i in range(0, n, chunk):
        got.append(sfe.push(y[i : i + chunk]))
        want.append(jsfe.push(y[i : i + chunk]))
        assert got[-1].shape == want[-1].shape
    got, want = np.concatenate(got + [sfe.close()]), np.concatenate(want + [jsfe.close()])
    one_shot = fe.compute_fbank(y, sr, device="cpu")
    assert got.shape == want.shape == one_shot.shape
    assert_logmel_close(got, want)
    assert_logmel_close(got, one_shot)
