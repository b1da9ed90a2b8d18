"""The port's beam search (± char-LM fusion) against the JAX package.

On the CPU the port's frontier wrapper runs ``beam_scan_plain``, the
reference its CUDA kernel K8 is held to on the card.  Here, on the same
numpy inputs and the same JAX parameters (converted with ``convert.py``),
its frontier trace must equal JAX's XLA scan ``_beam_scan`` and the TPU
kernel ``beam_device_pallas`` in interpret mode: tokens, parents, done
flags and hypothesis lengths exactly, final scores within 1e-5 (float32
sums of up to a dozen log-probs, taken in another order).  The backtracked
transcripts (best and n-best, with and without length normalisation) must
be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss_asr_tpu.decode import beam as jbeam
from ss_asr_tpu.models import charlm as jcharlm
from ss_asr_tpu.models import las as jlas
from ss_asr_tpu.ops.pallas.beam import beam_device_pallas
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.decode import beam
from ss_asr_tpu_torch.models import charlm, las
from ss_asr_tpu_torch.ops.kernels.beam import MAX_BEAM, beam_device
from ss_asr_tpu_torch.vocab import EOS_ID

torch.set_num_threads(1)

SIZES = dict(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=5)
JCFG = jlas.ASRConfig(**SIZES)
LCFG = jcharlm.CharLMConfig(hidden_size=8)
SCORE_TOL = 1e-5


def _models(seed, eos_bias=None):
    jp = jax.tree.map(np.asarray, jlas.init_asr(jax.random.key(seed), JCFG))
    if eos_bias is not None:
        jp["char_trans"]["b"] = jp["char_trans"]["b"].copy()
        jp["char_trans"]["b"][EOS_ID] = eos_bias
    model = las.LAS(las.ASRConfig(**SIZES))
    model.load_state_dict(convert.asr_state_from_params(jp))
    jlm = jax.tree.map(np.asarray, jcharlm.init_charlm(jax.random.key(seed + 100), LCFG))
    lm = charlm.CharLM(charlm.CharLMConfig(hidden_size=8))
    lm.load_state_dict(convert.charlm_state_from_params(jlm))
    return jp, model.eval(), jlm, lm.eval()


def _inputs(rng, lens, T=16):
    x = rng.standard_normal((len(lens), T, 5)).astype(np.float32)
    return x, np.asarray(lens, np.int32)


def _port_frontier(model, x, lens, K, T, lm=None, lm_weight=0.0):
    with torch.inference_mode():
        enc_h, enc_lens = las.listener_apply(model.encoder, torch.from_numpy(x),
                                             torch.from_numpy(lens))
        comp_h = las.attention_precompute(model.attention, enc_h)
        out = beam_device(model, enc_h, comp_h, enc_lens, K, T, lm, lm_weight)
    return [o.numpy() for o in out]


def _assert_frontier_equal(got, want):
    names = ("toks", "parents", "scores", "done", "hyp_len")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        if name == "scores":
            np.testing.assert_allclose(g, w, rtol=0, atol=SCORE_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("use_lm", [False, True], ids=["beam", "beam+lm"])
def test_frontier_matches_xla_scan(rng, K, use_lm):
    jp, model, jlm, lm = _models(K)
    x, xl = _inputs(rng, [16, 9, 3])
    T, w = 10, (0.6 if use_lm else 0.0)
    want = jbeam._beam_device(jp, JCFG, jnp.asarray(x), jnp.asarray(xl), K, T,
                              jlm if use_lm else None, LCFG, w, early_exit=True)
    got = _port_frontier(model, x, xl, K, T, lm if use_lm else None, w)
    _assert_frontier_equal(got, want)


@pytest.mark.parametrize("K,use_lm", [(1, False), (3, True), (8, False)])
def test_frontier_matches_pallas_kernel(rng, K, use_lm):
    jp, model, jlm, lm = _models(10 + K)
    x, xl = _inputs(rng, [16, 11])
    T, w = 8, (0.4 if use_lm else 0.0)
    want = beam_device_pallas(jp, JCFG, jnp.asarray(x), jnp.asarray(xl), beam_size=K,
                              max_steps=T, lm_params=jlm if use_lm else None, lm_cfg=LCFG,
                              lm_weight=w, interpret=True)
    got = _port_frontier(model, x, xl, K, T, lm if use_lm else None, w)
    _assert_frontier_equal(got, want)


@pytest.mark.parametrize("use_lm", [False, True], ids=["beam", "beam+lm"])
def test_early_exit_equals_fixed_trip(rng, use_lm):
    """An EOS bias ends every beam within a few steps: the port's early exit
    must leave exactly the fixed-trip scan's SOS tokens, identity parents
    and scores behind."""
    jp, model, jlm, lm = _models(5, eos_bias=2.5)
    x, xl = _inputs(rng, [16, 12])
    K, T, w = 3, 12, (0.5 if use_lm else 0.0)
    got = _port_frontier(model, x, xl, K, T, lm if use_lm else None, w)
    assert got[3].all(), "every beam should finish before max_steps"
    assert (got[0][-1] == 0).all() and (got[1][-1] == np.arange(K)).all()
    want = jbeam._beam_device(jp, JCFG, jnp.asarray(x), jnp.asarray(xl), K, T,
                              jlm if use_lm else None, LCFG, w, early_exit=False)
    _assert_frontier_equal(got, want)


@pytest.mark.parametrize("length_norm", [False, True], ids=["sum", "length_norm"])
@pytest.mark.parametrize("use_lm", [False, True], ids=["beam", "beam+lm"])
def test_beam_decode_and_nbest_match_jax(rng, length_norm, use_lm):
    jp, model, jlm, lm = _models(20, eos_bias=0.8)
    x, xl = _inputs(rng, [16, 10, 14])
    kw = dict(beam_size=4, max_steps=10, lm_weight=0.5 if use_lm else 0.0,
              length_norm=length_norm)
    want_t, want_l = jbeam.beam_decode(jp, JCFG, jnp.asarray(x), jnp.asarray(xl),
                                       lm_params=jlm if use_lm else None, lm_cfg=LCFG, **kw)
    xt, lt = torch.from_numpy(x), torch.from_numpy(xl)
    got_t, got_l = beam.beam_decode(model, xt, lt, lm=lm if use_lm else None, **kw)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_l, want_l)
    want = jbeam.beam_decode_nbest(jp, JCFG, jnp.asarray(x), jnp.asarray(xl),
                                   lm_params=jlm if use_lm else None, lm_cfg=LCFG, n_best=3,
                                   **kw)
    got = beam.beam_decode_nbest(model, xt, lt, lm=lm if use_lm else None, n_best=3, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=SCORE_TOL)


def test_beam_size_outside_the_kernel_range_raises(rng):
    _, model, _, _ = _models(0)
    x, xl = _inputs(rng, [16])
    with pytest.raises(ValueError, match=f"outside 1..{MAX_BEAM}"):
        _port_frontier(model, x, xl, MAX_BEAM + 1, 4)
    with pytest.raises(ValueError, match="n_best must be >= 1"):
        beam.beam_decode_nbest(model, torch.from_numpy(x), torch.from_numpy(xl), n_best=0)
