"""The port's attend-and-spell forward (K9's plain version) against the JAX
package.

JAX draws its scheduled-sampling numbers from a key outside the kernel
(``ops/pallas/spell.py:750-753``: one Bernoulli(tf) draw per step, Gumbel
noise per row); the test makes them from the same key and hands them to the
port as numpy, so both sides sample alike.  On the CPU the port's
``spell_fwd`` runs ``spell_fwd_plain``, the reference its CUDA kernel is held
to on the card.  Logits, attention weights and every other stream of the
TPU kernel must agree within 1e-5: float32 sums of a few hundred products
in another order, which the JAX package's own kernel-vs-scan test holds to
2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss_asr_tpu.models import charlm as jcharlm
from ss_asr_tpu.models import las as jlas
from ss_asr_tpu.ops.pallas import spell as jspell
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.models import charlm, las
from ss_asr_tpu_torch.ops.kernels.spell import spell_fwd
from ss_asr_tpu_torch.vocab import VOCAB_SIZE

torch.set_num_threads(1)

SIZES = dict(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=5)
JCFG = jlas.ASRConfig(**SIZES)
TOL = 1e-5


def _setup(rng, B=3, S=12, L=9):
    jp = jax.tree.map(np.asarray, jlas.init_asr(jax.random.key(0), JCFG))
    model = las.LAS(las.ASRConfig(**SIZES))
    model.load_state_dict(convert.asr_state_from_params(jp))
    enc_h = rng.standard_normal((B, S, JCFG.enc_out_dim)).astype(np.float32)
    enc_lens = np.asarray([S, S - 3, S - 7][:B], np.int32)
    y = rng.integers(1, VOCAB_SIZE, (B, L + 1)).astype(np.int32)
    return jp, model.eval(), enc_h, enc_lens, y


def _draws(key, tf, L, B):
    """JAX's scheduled-sampling numbers for ``key``, as attend_and_spell draws them."""
    k_tf, k_g = jax.random.split(key)
    tf_draws = (jax.random.uniform(k_tf, (L,)) <= tf).astype(jnp.float32)
    return np.asarray(tf_draws), np.asarray(jax.random.gumbel(k_g, (L, B, VOCAB_SIZE)))


def _mixed_key(tf, L, B):
    """The first key whose draws both feed the teacher and sample (tf < 1)."""
    for seed in range(100):
        d = _draws(jax.random.key(seed), tf, L, B)[0]
        if tf == 1.0 or 0 < d.sum() < L:
            return jax.random.key(seed)
    raise AssertionError("no key with mixed draws")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("tf", [1.0, 0.9])
def test_teacher_mode_matches_pallas_kernel_and_scan(rng, tf):
    jp, model, enc_h, enc_lens, y = _setup(rng)
    B, L = y.shape[0], y.shape[1] - 1
    key = _mixed_key(tf, L, B)
    tf_draws, gumbel = _draws(key, tf, L, B)
    args = (jp, JCFG, jnp.asarray(enc_h), jnp.asarray(enc_lens), L)
    want_k = jspell.attend_and_spell_pallas(*args, jnp.asarray(y), key, tf_rate=tf,
                                            interpret=True)
    want_s = jlas.attend_and_spell(*args, teacher=jnp.asarray(y), key=key, tf_rate=tf)
    with torch.no_grad():
        got = las.attend_and_spell(model, _t(enc_h), _t(enc_lens), L, teacher=_t(y),
                                   tf_draws=_t(tf_draws), gumbel=_t(gumbel))
    for want in (want_k, want_s):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=TOL)


def test_greedy_feedback_matches_pallas_kernel_and_scan(rng):
    jp, model, enc_h, enc_lens, _ = _setup(rng)
    L = 7
    args = (jp, JCFG, jnp.asarray(enc_h), jnp.asarray(enc_lens), L)
    want_k = jspell.attend_and_spell_pallas_greedy(*args, interpret=True)
    want_s = jlas.attend_and_spell(*args)
    with torch.no_grad():
        got = las.attend_and_spell(model, _t(enc_h), _t(enc_lens), L)
    for want in (want_k, want_s):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=TOL)


@pytest.mark.parametrize("tf", [1.0, 0.5])
def test_all_seven_streams_match_the_pallas_forward(rng, tf):
    """spell_fwd's streams against the TPU forward kernel's (the inputs the
    backward will read), lengths 0 and 1 included (clamped to 1)."""
    jp, model, enc_h, _, y = _setup(rng, B=4, S=10, L=6)
    enc_lens = np.asarray([10, 0, 1, 7], np.int32)
    B, L = y.shape[0], y.shape[1] - 1
    tf_draws, gumbel = _draws(_mixed_key(tf, L, B), tf, L, B)
    comp = jlas.attention_precompute(jp["attention"], jnp.asarray(enc_h))
    temb = jnp.swapaxes(jnp.take(jp["embed"]["table"], jnp.asarray(y)[:, 1:], axis=0), 0, 1)
    d = jp["decoder"]
    W = (jp["attention"]["phi"]["w"], d["layer1"]["w_ih"], d["layer1"]["w_hh"], d["layer1"]["b"],
         d["layer2"]["w_ih"], d["layer2"]["w_hh"], d["layer2"]["b"], jp["char_trans"]["w"],
         jp["char_trans"]["b"], jp["embed"]["table"])
    lens2d = jnp.maximum(jnp.asarray(enc_lens), 1).reshape(-1, 1)
    want = jspell._run_fwd(jnp.asarray(enc_h), comp, lens2d, jnp.asarray(tf_draws),
                           jnp.asarray(gumbel), temb, W, True)
    with torch.no_grad():
        got = spell_fwd(model, _t(enc_h), _t(np.asarray(comp)), _t(enc_lens), _t(tf_draws),
                        _t(gumbel), _t(np.asarray(temb)))
    names = ("logits", "a", "h1s", "c1s", "h2s", "c2s", "fed")
    assert len(got) == len(want) == 7
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("tf", [1.0, 0.5])
def test_charlm_teacher_forced_unroll_matches_jax(rng, tf):
    lcfg = jcharlm.CharLMConfig(hidden_size=8)
    jlm = jax.tree.map(np.asarray, jcharlm.init_charlm(jax.random.key(3), lcfg))
    lm = charlm.CharLM(charlm.CharLMConfig(hidden_size=8))
    lm.load_state_dict(convert.charlm_state_from_params(jlm))
    labels = rng.integers(1, VOCAB_SIZE, (3, 8)).astype(np.int32)
    key = _mixed_key(tf, 8, 3)
    want = jcharlm.teacher_forced_unroll(jlm, lcfg, jnp.asarray(labels), key, tf_rate=tf)
    tf_draws, gumbel = _draws(key, tf, 8, 3)
    with torch.no_grad():
        got = charlm.teacher_forced_unroll(lm, _t(labels).long(), _t(tf_draws), _t(gumbel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_charlm_config_keeps_tf_rate():
    """``from_dict`` keeps the config's tf_rate (0.9 by default), as the JAX
    config does, and drops keys neither config knows."""
    d = {"hidden_size": 16, "tf_rate": 0.75, "unknown": 1}
    got, want = charlm.CharLMConfig.from_dict(d), jcharlm.CharLMConfig.from_dict(d)
    assert (got.hidden_size, got.tf_rate) == (want.hidden_size, want.tf_rate) == (16, 0.75)
    assert charlm.CharLMConfig().tf_rate == jcharlm.CharLMConfig().tf_rate == 0.9


def test_scheduled_sampling_draws_are_seeded():
    cfg = las.ASRConfig(**SIZES)
    a = las.draw_scheduled_sampling(40, 3, 0.9, cfg, torch.Generator().manual_seed(1), device="cpu")
    b = las.draw_scheduled_sampling(40, 3, 0.9, cfg, torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[1].shape == (40, 3, VOCAB_SIZE) and torch.isfinite(a[1]).all()
    assert set(a[0].tolist()) <= {0.0, 1.0} and 0 < a[0].sum() < 40
