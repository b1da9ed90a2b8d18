"""The port's packed LSTM against the JAX LSTM kernels and scans.

``lstm_seq_plain`` (the plain version of the port's LSTM kernel) and
``bilstm`` (both directions through the kernel wrapper, which takes the
plain version for CPU tensors) are held, on the same numpy inputs and JAX
parameters, against ``lstm_scan_pallas_trainable`` in interpret mode (TPU
kernel K2, forward and reverse), the one-step-per-grid ``lstm_seq_pallas``
(K1), the fused dual-direction ``bilstm_pallas_trainable`` (K4) and the
``lax.scan`` path.  Lengths include 0 and 1.  Tolerance 1e-5 absolute: the
same float32 cell math, summed in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss_asr_tpu.ops import rnn as jrnn
from ss_asr_tpu.ops.pallas import lstm as jlstm
from ss_asr_tpu.ops.pallas.bilstm import bilstm_pallas_trainable
from ss_asr_tpu_torch.ops import rnn
from ss_asr_tpu_torch.ops.kernels.lstm import lstm_fwd, lstm_seq_plain

torch.set_num_threads(1)

ATOL = 1e-5
LENGTHS = {"ragged": [9, 7, 1, 0, 4], "full": [9, 9, 9, 9, 9], "short": [0, 1, 2, 0, 1]}


def _setup(rng, seed=0, B=5, T=9, In=6, H=8):
    p = jrnn.init_bilstm(jax.random.key(seed), In, H)
    xs = rng.standard_normal((B, T, In)).astype(np.float32)
    return p, xs


def _port_bilstm(p, In, H):
    from ss_asr_tpu_torch import convert

    sd = {}
    convert._bilstm_to(jax.tree.map(np.asarray, p), "m", sd)
    m = rnn.BiLSTM(In, H)
    m.load_state_dict({k[2:]: v for k, v in sd.items()})
    return m


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


@pytest.mark.parametrize("lens", list(LENGTHS), ids=list(LENGTHS))
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_lstm_seq_plain_matches_pallas_trainable(rng, lens, reverse):
    p, xs = _setup(rng)
    d = p["bwd" if reverse else "fwd"]
    lengths = np.asarray(LENGTHS[lens], np.int32)
    want = jlstm.lstm_scan_pallas_trainable(
        d, jnp.asarray(xs), jnp.asarray(lengths), interpret=True, reverse=reverse)
    gx = np.einsum("btf,fg->tbg", xs, np.asarray(d["w_ih"])) + np.asarray(d["b"])
    y, cs = lstm_seq_plain(_t(gx), _t(d["w_hh"]), _t(lengths, torch.int32), reverse=reverse)
    np.testing.assert_allclose(y.numpy().swapaxes(0, 1), np.asarray(want), atol=ATOL)
    # the cell-state stream equals the TPU kernel's residual output
    _, want_cs = jlstm._fwd_pallas(jnp.asarray(gx), d["w_hh"], jnp.asarray(lengths),
                                   True, reverse)
    np.testing.assert_allclose(cs.numpy(), np.asarray(want_cs), atol=ATOL)
    assert np.all(y.numpy()[:, lengths == 0] == 0.0)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_lstm_scan_matches_jax_scan(rng, reverse):
    p, xs = _setup(rng, seed=1)
    lengths = np.asarray(LENGTHS["ragged"], np.int32)
    want, _ = jrnn.lstm_scan(p["bwd" if reverse else "fwd"], jnp.asarray(xs),
                             jnp.asarray(lengths), reverse=reverse)
    m = _port_bilstm(p, 6, 8)
    got = rnn.lstm_scan(m, _t(xs), _t(lengths, torch.int32), reverse=reverse)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


def test_lstm_fwd_single_direction_matches_k1(rng):
    """TPU kernel K1 (lstm_seq_pallas) is K2's forward output."""
    p, xs = _setup(rng, seed=2)
    lengths = np.asarray(LENGTHS["ragged"], np.int32)
    gx = np.einsum("btf,fg->tbg", xs, np.asarray(p["fwd"]["w_ih"])) + np.asarray(p["fwd"]["b"])
    want = jlstm.lstm_seq_pallas(jnp.asarray(gx), p["fwd"]["w_hh"], jnp.asarray(lengths),
                                 interpret=True)
    y, _ = lstm_fwd(_t(gx)[None], _t(p["fwd"]["w_hh"])[None], _t(lengths, torch.int32), (False,))
    np.testing.assert_allclose(y[0].numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("lens", ["ragged", "short"])
def test_bilstm_matches_jax(rng, lens):
    p, xs = _setup(rng, seed=3)
    lengths = np.asarray(LENGTHS[lens], np.int32)
    m = _port_bilstm(p, 6, 8)
    with torch.no_grad():
        got = rnn.bilstm(m, _t(xs), _t(lengths, torch.int32)).numpy()
    want_scan = jrnn.bilstm_scan(p, jnp.asarray(xs), jnp.asarray(lengths))
    np.testing.assert_allclose(got, np.asarray(want_scan), atol=ATOL)
    # the fused dual-direction TPU kernel K4 computes the same layer
    want_k4 = bilstm_pallas_trainable(p, jnp.asarray(xs), jnp.asarray(lengths), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_k4), atol=ATOL)


def test_downsample_time_drops_odd_tail(rng):
    x = rng.standard_normal((2, 7, 3)).astype(np.float32)
    lens = np.asarray([7, 2], np.int32)
    want, wl = jrnn.downsample_time(jnp.asarray(x), jnp.asarray(lens))
    got, gl = rnn.downsample_time(_t(x), _t(lens, torch.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


def test_lstm_fwd_rejects_bad_shapes():
    gx = torch.zeros(2, 3, 4, 32)
    with pytest.raises(ValueError, match="lstm_fwd"):
        lstm_fwd(gx, torch.zeros(2, 8, 32), torch.zeros(4, dtype=torch.int32), (False,))
    with pytest.raises(ValueError, match="no kernel"):
        lstm_fwd(gx.to("meta"), torch.zeros(2, 8, 32, device="meta"),
                 torch.zeros(4, dtype=torch.int32), (False, True))
