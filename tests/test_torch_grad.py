"""The port's gradients against the JAX package's, through the plain
versions of the backward kernels K3 (and K5) and K10.

* ``LSTMSeq`` (the differentiable packed LSTM loop; on the CPU its forward
  is ``lstm_seq_plain``, its backward ``lstm_bwd_plain``), one direction
  and both, with ragged lengths (0 and 1 included), against ``jax.grad`` of
  ``lstm_scan_pallas_trainable`` (K2 + K3, interpret mode) and of
  ``bilstm_pallas_trainable`` (K4 + K5): atol 1e-4, the JAX package's own
  kernel-vs-scan tolerance (``tests/test_pallas_lstm.py``).  A float64
  ``gradcheck`` holds the plain backward to finite differences.
* ``SpellCore`` (on the CPU: ``spell_fwd_plain`` + ``spell_bwd_plain``)
  against ``jax.grad`` of ``attend_and_spell_pallas`` (K9 + K10, interpret
  mode) at tf 1.0 and 0.5 and with a loss on the attention maps: loss rtol
  1e-5, parameters atol 3e-5, the encoder memory atol 2e-5, the JAX
  package's own tolerances (``tests/test_pallas_spell.py``).  The
  embedding table's gradient sums both of its routes: the teacher rows and
  the fed-back sampled rows.
* The whole train-step loss: ``asr_forward`` + ``masked_ce_per_utt``
  against ``jax.value_and_grad`` of the JAX step, every one of the 36
  parameter leaves.

JAX's scheduled-sampling numbers are drawn from a key and handed to the
port as numpy, so both sides sample alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss_asr_tpu.models import las as jlas
from ss_asr_tpu.ops import rnn as jrnn
from ss_asr_tpu.ops.pallas import lstm as jlstm
from ss_asr_tpu.ops.pallas.bilstm import bilstm_pallas_trainable
from ss_asr_tpu.ops.pallas.spell import attend_and_spell_pallas
from ss_asr_tpu.train import losses as jlosses
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops import rnn
from ss_asr_tpu_torch.ops.kernels.lstm import LSTMSeq
from ss_asr_tpu_torch.train import losses
from ss_asr_tpu_torch.vocab import VOCAB_SIZE

torch.set_num_threads(1)

SIZES = dict(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=5)
JCFG = jlas.ASRConfig(**SIZES)
LENS = [9, 7, 1, 0, 4]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _model(jp, sizes=SIZES):
    model = las.LAS(las.ASRConfig(**sizes))
    model.load_state_dict(convert.asr_state_from_params(jax.tree.map(np.asarray, jp)))
    return model


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


def _close(got, want, atol, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_lstmseq_grads_match_k3(rng, reverse):
    """One direction (D = 1): dgx, dW_hh and through them dW_ih, db, dx."""
    B, T, In, H = 5, 9, 6, 8
    p = jrnn.init_lstm(jax.random.key(4), In, H)
    xs = rng.standard_normal((B, T, In)).astype(np.float32)
    w = rng.standard_normal((B, T, H)).astype(np.float32)
    lens = np.asarray(LENS, np.int32)

    def loss(p, x):
        y = jlstm.lstm_scan_pallas_trainable(p, x, jnp.asarray(lens), interpret=True,
                                             reverse=reverse)
        return jnp.sum(y * w)

    gp, gx = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(xs))
    w_ih, w_hh, b = (_t(p[k]).requires_grad_() for k in ("w_ih", "w_hh", "b"))
    x = _t(xs).requires_grad_()
    gates = rnn.input_gates(x, w_ih.t(), b)
    y = LSTMSeq.apply(gates[None], w_hh[None], _t(lens, torch.int32), (reverse,))[0]
    (y.transpose(0, 1) * _t(w)).sum().backward()
    _close(x.grad, gx, 1e-4, "x")
    for name, t in (("w_ih", w_ih), ("w_hh", w_hh), ("b", b)):
        _close(t.grad, gp[name], 1e-4, name)


def test_bilstm_grads_match_k5(rng):
    """Both directions in one LSTMSeq call (D = 2, as rnn.bilstm runs a
    layer) against the fused dual-direction TPU kernels K4 + K5."""
    B, T, In, H = 5, 9, 6, 8
    p = jrnn.init_bilstm(jax.random.key(5), In, H)
    xs = rng.standard_normal((B, T, In)).astype(np.float32)
    w = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    lens = np.asarray(LENS, np.int32)

    def loss(p, x):
        return jnp.sum(bilstm_pallas_trainable(p, x, jnp.asarray(lens), interpret=True) * w)

    gp, gx = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(xs))
    sd = {}
    convert._bilstm_to(jax.tree.map(np.asarray, p), "m", sd)
    m = rnn.BiLSTM(In, H)
    m.load_state_dict({k[2:]: v for k, v in sd.items()})
    x = _t(xs).requires_grad_()
    (rnn.bilstm(m, x, _t(lens, torch.int32)) * _t(w)).sum().backward()
    _close(x.grad, gx, 1e-4, "x")
    for d, sfx in (("fwd", "l0"), ("bwd", "l0_reverse")):
        _close(getattr(m, f"weight_ih_{sfx}").grad.t(), gp[d]["w_ih"], 1e-4, f"{d} w_ih")
        _close(getattr(m, f"weight_hh_{sfx}").grad.t(), gp[d]["w_hh"], 1e-4, f"{d} w_hh")
        _close(getattr(m, f"bias_ih_{sfx}").grad, gp[d]["b"], 1e-4, f"{d} b")
        _close(getattr(m, f"bias_hh_{sfx}").grad, gp[d]["b"], 1e-4, f"{d} b (hh)")


def test_lstmseq_plain_backward_passes_gradcheck():
    g = torch.Generator().manual_seed(0)
    gx = torch.randn(2, 6, 3, 16, dtype=torch.float64, generator=g).requires_grad_()
    whh = (0.3 * torch.randn(2, 4, 16, dtype=torch.float64, generator=g)).requires_grad_()
    lens = torch.tensor([6, 3, 0])
    assert torch.autograd.gradcheck(
        lambda a, b: LSTMSeq.apply(a, b, lens, (False, True)), (gx, whh))


SPELL_LEAVES = (
    ("attention", "phi", "w"), ("attention", "psi", "w"), ("attention", "psi", "b"),
    ("decoder", "layer1", "w_ih"), ("decoder", "layer1", "w_hh"), ("decoder", "layer1", "b"),
    ("decoder", "layer2", "w_ih"), ("decoder", "layer2", "w_hh"), ("decoder", "layer2", "b"),
    ("char_trans", "w"), ("char_trans", "b"), ("embed", "table"),
)


def _grad_tree(model):
    """The port's parameter gradients in the JAX tree layout (w [in, out]).
    bias_ih and bias_hh each receive the merged bias's gradient: count it once."""
    return convert.asr_params_from_state(
        {k: (torch.zeros_like(p) if p.grad is None or ".bias_hh" in k else p.grad)
         for k, p in model.named_parameters()})


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("tf,att_weight", [(1.0, 0.0), (0.5, 0.0), (1.0, 0.5)],
                         ids=["teacher", "sampled", "attention-cotangent"])
def test_spellcore_grads_match_k10(rng, tf, att_weight):
    B, S, L = 3, 12, 9
    jp = jlas.init_asr(jax.random.key(0), JCFG)
    enc_h = rng.standard_normal((B, S, JCFG.enc_out_dim)).astype(np.float32)
    enc_lens = np.asarray([S, S - 3, S - 7], np.int32)
    y = rng.integers(1, VOCAB_SIZE, (B, L + 1)).astype(np.int32)
    key = _mixed_key(tf, L, B)
    tf_draws, gumbel = _draws(key, tf, L, B)

    def jloss(p, eh):
        logits, att = attend_and_spell_pallas(p, JCFG, eh, jnp.asarray(enc_lens), L,
                                              jnp.asarray(y), key, tf_rate=tf, interpret=True)
        ce = jlosses.masked_ce_per_utt(logits, jnp.asarray(y)[:, 1:], jnp.asarray(y))
        return ce + att_weight * jnp.mean(jnp.sum(att ** 2, axis=-1))

    want, (gp, ge) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jnp.asarray(enc_h))
    model = _model(jp)
    eh = _t(enc_h).requires_grad_()
    logits, att = las.attend_and_spell(model, eh, _t(enc_lens, torch.int32), L, teacher=_t(y),
                                       tf_draws=_t(tf_draws), gumbel=_t(gumbel))
    got = losses.masked_ce_per_utt(logits, _t(y, torch.long)[:, 1:], _t(y, torch.long))
    if att_weight:
        got = got + att_weight * (att ** 2).sum(-1).mean()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _close(eh.grad, ge, 2e-5, "enc_h")
    tree = _grad_tree(model)
    for path in SPELL_LEAVES:
        _close(_t(_leaf(tree, path)), _leaf(gp, path), 3e-5, "/".join(path))
    # the listener takes no part in the speller's gradient
    assert model.encoder.blstm_1.layer.weight_ih_l0.grad is None


def test_train_step_loss_and_grads_match_jax(rng):
    """asr_forward + masked_ce_per_utt at tf 0.5, every parameter leaf."""
    B, T, L = 3, 40, 7
    jp = jlas.init_asr(jax.random.key(2), JCFG)
    x = rng.standard_normal((B, T, JCFG.feature_dim)).astype(np.float32)
    x_lens = np.asarray([40, 29, 17], np.int32)
    y = rng.integers(2, VOCAB_SIZE, (B, L + 1)).astype(np.int32)
    y[:, 0] = 0
    y[2, 5:] = 0  # a padded row: the mask and the per-utterance normaliser
    key = _mixed_key(0.5, L, B)
    tf_draws, gumbel = _draws(key, 0.5, L, B)

    def jloss(p):
        _, logits, _ = jlas.asr_forward(p, JCFG, jnp.asarray(x), jnp.asarray(x_lens), L,
                                        teacher=jnp.asarray(y), key=key, tf_rate=0.5)
        return jlosses.masked_ce_per_utt(logits, jnp.asarray(y)[:, 1:], jnp.asarray(y))

    want, gp = jax.value_and_grad(jloss)(jp)
    model = _model(jp)
    _, logits, _ = las.asr_forward(model, _t(x), _t(x_lens, torch.int32), L, teacher=_t(y),
                                   tf_draws=_t(tf_draws), gumbel=_t(gumbel))
    yt = _t(y, torch.long)
    got = losses.masked_ce_per_utt(logits, yt[:, 1:], yt)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    tree = _grad_tree(model)
    leaves = jax.tree_util.tree_leaves_with_path(gp)
    assert len(leaves) == 36
    for path, g in leaves:
        keys = tuple(k.key for k in path)
        _close(_t(_leaf(tree, keys)), g, 1e-4, "/".join(keys))
