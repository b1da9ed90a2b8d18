"""Listen-Attend-Spell: modules keyed like the reference state_dict, and
the functions over them that serving and training run.

Port of ``ss_asr_tpu/models/las.py``.  ``LAS.state_dict()``
has exactly the keys of the reference ASR (and of ``export_asr`` in
``ss_asr_tpu/utils/torch_import.py``): ``encoder.blstm_{1,2,3}.layer.*``,
``encoder.blstm_4.*``, ``attention.{phi,psi}.*``,
``decoder.layer_{1,2}.*``, ``embed.weight``, ``char_trans.*``.

* Listener: 3 pyramidal BiLSTMs (each halves time and doubles features by
  frame concat) + 1 BiLSTM over time -> [B, T//8, 2*state].
* Attention: softmax(tanh(phi(h1)) . tanh(psi(h))), -inf past each
  (clamped >= 1) encoder length.
* Speller: 2 stacked LSTM cells; attention reads the first cell's h.
* ``attend_and_spell``: the speller loop over L steps with teacher forcing
  / scheduled sampling or greedy feedback (the train step, validation and
  the forced-alignment pass, and the text autoencoder's decode over its
  own memory).  Its random numbers are explicit inputs.
* ``asr_forward``: listener + attend-and-spell, the train step's forward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ss_asr_tpu_torch.ops import rnn
from ss_asr_tpu_torch.vocab import VOCAB_SIZE


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    """Model hyperparameters (conf/default.yaml asr.mdl section)."""

    vocab_size: int = VOCAB_SIZE
    encoder_state_size: int = 256
    decoder_state_size: int = 256
    mlp_out_size: int = 128
    feature_dim: int = 40
    tf_rate: float = 0.9

    @property
    def enc_out_dim(self) -> int:
        return 2 * self.encoder_state_size

    @classmethod
    def from_dict(cls, d: dict) -> "ASRConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class PBLSTM(nn.Module):
    """Pyramidal layer: the reference wraps its LSTM in ``.layer``."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.layer = rnn.BiLSTM(in_dim, hidden)


class Listener(nn.Module):
    def __init__(self, cfg: ASRConfig):
        super().__init__()
        s = cfg.encoder_state_size
        self.blstm_1 = PBLSTM(cfg.feature_dim, s)
        self.blstm_2 = PBLSTM(4 * s, s)
        self.blstm_3 = PBLSTM(4 * s, s)
        self.blstm_4 = rnn.BiLSTM(4 * s, s)


class Attention(nn.Module):
    def __init__(self, cfg: ASRConfig):
        super().__init__()
        self.phi = nn.Linear(cfg.decoder_state_size, cfg.mlp_out_size, bias=False)
        self.psi = nn.Linear(cfg.enc_out_dim, cfg.mlp_out_size)


class Speller(nn.Module):
    def __init__(self, cfg: ASRConfig):
        super().__init__()
        d = cfg.decoder_state_size
        # input = [char_embed(d) | context(enc_out)]
        self.layer_1 = nn.LSTMCell(d + cfg.enc_out_dim, d)
        self.layer_2 = nn.LSTMCell(d, d)


class LAS(nn.Module):
    """The ASR model's parameters; see the functions below for its use."""

    def __init__(self, cfg: ASRConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Listener(cfg)
        self.attention = Attention(cfg)
        self.decoder = Speller(cfg)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.decoder_state_size)
        self.char_trans = nn.Linear(cfg.decoder_state_size, cfg.vocab_size)


def listener_apply(
    p: Listener, x: torch.Tensor, lengths: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T, feat] -> ([B, T//8, 2*state], enc_lens)."""
    for layer in (p.blstm_1, p.blstm_2, p.blstm_3):
        x = rnn.bilstm(layer.layer, x, lengths)
        x, lengths = rnn.downsample_time(x, lengths)
    return rnn.bilstm(p.blstm_4, x, lengths), lengths


def attention_precompute(p: Attention, h: torch.Tensor) -> torch.Tensor:
    """tanh(psi(h)), once per utterance — [B, S, mlp]."""
    return torch.tanh(rnn.linear(p.psi, h))


def attention_mask(enc_lens: torch.Tensor, S: int) -> torch.Tensor:
    """[B, S] True at valid encoder positions; lengths clamp to >= 1 so a
    row with no encoder steps attends to one padding step, not NaN."""
    pos = torch.arange(S, device=enc_lens.device)[None, :]
    return pos < torch.clamp(enc_lens, min=1)[:, None]


def attention_step(
    p: Attention, comp_h: torch.Tensor, h: torch.Tensor, dec_state: torch.Tensor,
    valid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One content-attention step: (score [B, S], context [B, F])."""
    q = torch.tanh(rnn.linear(p.phi, dec_state))
    energy = torch.einsum("bsm,bm->bs", comp_h, q)
    energy = energy.masked_fill(~valid, float("-inf"))
    score = torch.softmax(energy, dim=-1)
    return score, torch.einsum("bs,bsf->bf", score, h)


def speller_init_state(batch: int, cfg: ASRConfig, device, dtype=torch.float32) -> tuple:
    z = torch.zeros(batch, cfg.decoder_state_size, device=device, dtype=dtype)
    return ((z, z), (z, z))  # ((h1, c1), (h2, c2))


def speller_step(p: Speller, x: torch.Tensor, state) -> tuple:
    """x: [B, enc_out + d]; returns (new_state, out [B, d])."""
    s1, s2 = state
    h1, c1 = rnn.lstm_step(p.layer_1, x, s1)
    h2, c2 = rnn.lstm_step(p.layer_2, h1, s2)
    return ((h1, c1), (h2, c2)), h2


def draw_scheduled_sampling(
    decode_step: int, batch: int, tf_rate: float, cfg: ASRConfig,
    generator: Optional[torch.Generator] = None, *, device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random numbers of one scheduled-sampling unroll, as the JAX
    package draws them outside its kernel (ops/pallas/spell.py:750-753):
    ``tf_draws [L]`` float 0/1, one Bernoulli(tf_rate) draw per step shared
    by the batch, and Gumbel noise ``gumbel [L, B, V]`` for the sampling
    argmax, drawn on the host and moved to ``device`` (required).
    ``torch.Generator`` streams differ from ``jax.random``'s."""
    tf_draws = (torch.rand(decode_step, generator=generator) <= tf_rate).to(torch.float32)
    return tf_draws.to(device), gumbel_noise((decode_step, batch, cfg.vocab_size),
                                             generator).to(device)


def gumbel_noise(shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Gumbel(0, 1) noise on the host, from uniforms in [tiny, 1) as
    ``jax.random.gumbel`` draws them."""
    u = torch.rand(shape, generator=generator).clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def attend_and_spell(
    model: LAS, enc_h: torch.Tensor, enc_lens: torch.Tensor, decode_step: int,
    teacher: Optional[torch.Tensor] = None, tf_draws: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None, tf_cutoff_last: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the attention + speller loop for ``decode_step`` characters ->
    ``(logits [B, L, V], attention [B, L, S])``.

    ``teacher`` [B, >= L+1] target ids (SOS first): after step t the loop
    feeds ``teacher[:, t+1]`` where ``tf_draws[t]`` is 1 and the Gumbel-argmax
    of the logits (``gumbel [L, B, V]`` noise) where it is 0; without
    ``tf_draws`` every step feeds the teacher, without ``gumbel`` the noise
    is zero.  ``teacher=None``: greedy feedback of the logits' argmax.
    The loop is ``ops.kernels.spell``: the CUDA kernels on the card, their
    plain versions on the CPU; through ``SpellCore`` (forward and backward)
    when a gradient is needed, through ``spell_fwd`` alone otherwise.

    ``tf_cutoff_last`` (the text autoencoder's ``t < decode_step - 1``
    guard: the last step feeds back the argmax even under a teacher) is
    accepted and changes nothing: it only replaces the character fed AFTER
    the last step, which no step consumes, so the logits, the attention and
    every gradient are the same with and without it
    (``tests/test_torch_tae.py`` holds that against the JAX scan).  The JAX
    package keeps the flag off its kernel; here the text autoencoder decodes
    through the same kernels as the ASR."""
    del tf_cutoff_last
    # imported here: ops.kernels.spell builds its plain version on this module
    from ss_asr_tpu_torch.ops.kernels.decode import speller_weights
    from ss_asr_tpu_torch.ops.kernels.spell import SpellCore, spell_fwd

    B, S, _ = enc_h.shape
    L, dev = decode_step, enc_h.device
    cfg = model.cfg
    if teacher is None:
        tf_draws = torch.zeros(L, device=dev)
        gumbel = torch.zeros(L, B, cfg.vocab_size, device=dev)
        teacher_emb = torch.zeros(L, B, cfg.decoder_state_size, device=dev)
    else:
        teacher_emb = rnn.embed(model.embed, teacher[:, 1 : L + 1].to(dev).long()).transpose(0, 1)
        tf_draws = torch.ones(L, device=dev) if tf_draws is None else tf_draws.to(dev)
        if gumbel is None:
            gumbel = torch.zeros(L, B, cfg.vocab_size, device=dev)
    comp_h = attention_precompute(model.attention, enc_h)
    args = (model, enc_h, comp_h, enc_lens, tf_draws.to(torch.float32), gumbel.to(dev),
            teacher_emb.contiguous())
    if torch.is_grad_enabled() and (enc_h.requires_grad
                                    or any(p.requires_grad for p in model.parameters())):
        logits, a = SpellCore.apply(*args, *speller_weights(model))
    else:
        logits, a, *_ = spell_fwd(*args)
    return logits.transpose(0, 1), a.transpose(0, 1)


def asr_forward(
    model: LAS, x: torch.Tensor, x_lens: torch.Tensor, decode_step: int,
    teacher: Optional[torch.Tensor] = None, tf_draws: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, T, feat] -> ``(enc_lens, logits [B, L, V], att [B, L, S])``: the
    listener, then ``attend_and_spell`` with the same feedback arguments."""
    enc_h, enc_lens = listener_apply(model.encoder, x, x_lens)
    logits, scores = attend_and_spell(model, enc_h, enc_lens, decode_step, teacher,
                                      tf_draws, gumbel)
    return enc_lens, logits, scores
