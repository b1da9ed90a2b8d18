"""The port's greedy decode (± char-LM fusion) against the JAX decode kernels.

On the CPU the port's decode wrapper runs ``greedy_decode_plain``, the
reference its CUDA kernels are held to on the card.  Here it must give
exactly the tokens and lengths of the JAX TPU kernels in interpret mode,
``greedy_decode_pallas`` (K6) and ``greedy_decode_lm_pallas`` (K7), on the
same numpy inputs and the same JAX parameters (converted with
``convert.py``), including masked lengths and the all-done early exit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss_asr_tpu.decode.greedy import greedy_decode_early_exit as jgreedy
from ss_asr_tpu.models import charlm as jcharlm
from ss_asr_tpu.models import las as jlas
from ss_asr_tpu.ops.pallas.decode import greedy_decode_lm_pallas, greedy_decode_pallas
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.decode.greedy import _finalize, greedy_decode_early_exit
from ss_asr_tpu_torch.models import charlm, las
from ss_asr_tpu_torch.ops.kernels.decode import greedy_decode
from ss_asr_tpu_torch.vocab import EOS_ID

torch.set_num_threads(1)

SIZES = dict(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=5)


def _models(seed, lm_hidden=8, eos_bias=None):
    jp = jax.tree.map(np.asarray, jlas.init_asr(jax.random.key(seed), jlas.ASRConfig(**SIZES)))
    if eos_bias is not None:
        jp["char_trans"]["b"] = jp["char_trans"]["b"].copy()
        jp["char_trans"]["b"][EOS_ID] = eos_bias
    model = las.LAS(las.ASRConfig(**SIZES))
    model.load_state_dict(convert.asr_state_from_params(jp))
    lcfg = jcharlm.CharLMConfig(hidden_size=lm_hidden)
    jlm = jax.tree.map(np.asarray, jcharlm.init_charlm(jax.random.key(seed + 100), lcfg))
    lm = charlm.CharLM(charlm.CharLMConfig(hidden_size=lm_hidden))
    lm.load_state_dict(convert.charlm_state_from_params(jlm))
    return jp, model, lcfg, jlm, lm


def _inputs(rng, lens, T=24):
    x = rng.standard_normal((len(lens), T, 5)).astype(np.float32)
    return x, np.asarray(lens, np.int32)


def _port(model, x, lens, max_steps, lm=None, lm_weight=0.0):
    with torch.inference_mode():
        toks, tl = greedy_decode_early_exit(model, torch.from_numpy(x), torch.from_numpy(lens),
                                            max_steps=max_steps, lm=lm, lm_weight=lm_weight)
    return toks.numpy(), tl.numpy()


@pytest.mark.parametrize("seed,lens", [(0, [24, 24]), (1, [24, 9]), (2, [16, 3, 24])])
def test_greedy_matches_pallas_kernel(rng, seed, lens):
    jp, model, *_ = _models(seed)
    x, xl = _inputs(rng, lens)
    want_t, want_l = greedy_decode_pallas(jp, jlas.ASRConfig(**SIZES), jnp.asarray(x),
                                          jnp.asarray(xl), max_steps=12, interpret=True)
    got_t, got_l = _port(model, x, xl, 12)
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    np.testing.assert_array_equal(got_l, np.asarray(want_l))


@pytest.mark.parametrize("seed,lm_weight", [(3, 0.7), (4, 0.3)])
def test_greedy_lm_matches_pallas_kernel(rng, seed, lm_weight):
    jp, model, lcfg, jlm, lm = _models(seed)
    x, xl = _inputs(rng, [24, 10])
    want_t, want_l = greedy_decode_lm_pallas(jp, jlas.ASRConfig(**SIZES), jnp.asarray(x),
                                             jnp.asarray(xl), jlm, lm_weight, max_steps=10,
                                             interpret=True)
    got_t, got_l = _port(model, x, xl, 10, lm=lm, lm_weight=lm_weight)
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    np.testing.assert_array_equal(got_l, np.asarray(want_l))
    # and the JAX scan path with the LM agrees
    want_s, _ = jgreedy(jp, jlas.ASRConfig(**SIZES), jnp.asarray(x), jnp.asarray(xl),
                        max_steps=10, lm_params=jlm, lm_cfg=lcfg, lm_weight=lm_weight)
    np.testing.assert_array_equal(got_t, np.asarray(want_s))


def test_early_exit_all_done(rng):
    """An EOS bias makes every row finish at step 0: the remaining steps are
    the all-done pad branch of the TPU kernel."""
    jp, model, *_ = _models(5, eos_bias=50.0)
    x, xl = _inputs(rng, [24, 24])
    want_t, want_l = greedy_decode_pallas(jp, jlas.ASRConfig(**SIZES), jnp.asarray(x),
                                          jnp.asarray(xl), max_steps=12, interpret=True)
    got_t, got_l = _port(model, x, xl, 12)
    assert int(got_l.max()) <= 1
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    np.testing.assert_array_equal(got_l, np.asarray(want_l))


def test_raw_tokens_pad_with_sos_after_eos(rng):
    """The wrapper's raw tokens: EOS once, then SOS for the row's rest."""
    _, model, *_ = _models(6, eos_bias=50.0)
    x, xl = _inputs(rng, [24, 8])
    with torch.inference_mode():
        enc_h, enc_lens = las.listener_apply(model.encoder, torch.from_numpy(x),
                                             torch.from_numpy(xl))
        comp_h = las.attention_precompute(model.attention, enc_h)
        raw = greedy_decode(model, enc_h, comp_h, enc_lens, 6).numpy()
    np.testing.assert_array_equal(raw[:, 0], [EOS_ID, EOS_ID])
    np.testing.assert_array_equal(raw[:, 1:], 0)


def test_finalize_matches_jax():
    from ss_asr_tpu.decode.greedy import _finalize as jfinalize

    toks = np.asarray([[5, 6, 1, 7, 0], [5, 6, 7, 8, 9], [1, 3, 3, 0, 0]], np.int32)
    want_t, want_l = jfinalize(jnp.asarray(toks), 5)
    got_t, got_l = _finalize(torch.from_numpy(toks), 5)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_vocab_and_translate_equal_jax():
    from ss_asr_tpu import vocab as jvocab
    from ss_asr_tpu_torch import vocab

    assert vocab.VOCAB == jvocab.VOCAB and vocab.VOCAB_SIZE == jvocab.VOCAB_SIZE
    assert (vocab.SOS_ID, vocab.EOS_ID) == (jvocab.SOS_ID, jvocab.EOS_ID)
    rng = np.random.default_rng(0)
    for _ in range(20):
        ids = rng.integers(0, vocab.VOCAB_SIZE, size=12)
        assert vocab.Mapper().translate(ids) == jvocab.Mapper().translate(ids)
