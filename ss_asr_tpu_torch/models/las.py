"""Listen-Attend-Spell: modules keyed like the reference state_dict, and
the serving-path functions over them.

Port of ``ss_asr_tpu/models/las.py`` (inference half).  ``LAS.state_dict()``
has exactly the keys of the reference ASR (and of ``export_asr`` in
``ss_asr_tpu/utils/torch_import.py``): ``encoder.blstm_{1,2,3}.layer.*``,
``encoder.blstm_4.*``, ``attention.{phi,psi}.*``,
``decoder.layer_{1,2}.*``, ``embed.weight``, ``char_trans.*``.

* Listener: 3 pyramidal BiLSTMs (each halves time and doubles features by
  frame concat) + 1 BiLSTM over time -> [B, T//8, 2*state].
* Attention: softmax(tanh(phi(h1)) . tanh(psi(h))), -inf past each
  (clamped >= 1) encoder length.
* Speller: 2 stacked LSTM cells; attention reads the first cell's h.

Teacher forcing and scheduled sampling are training and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from ss_asr_tpu_torch.ops import rnn
from ss_asr_tpu_torch.vocab import VOCAB_SIZE


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    """Model hyperparameters (conf/default.yaml asr.mdl section; the
    training-only ``tf_rate`` is not read)."""

    vocab_size: int = VOCAB_SIZE
    encoder_state_size: int = 256
    decoder_state_size: int = 256
    mlp_out_size: int = 128
    feature_dim: int = 40

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


def speller_init_state(batch: int, cfg: ASRConfig, device) -> tuple:
    z = torch.zeros(batch, cfg.decoder_state_size, device=device)
    return ((z, z), (z, z))  # ((h1, c1), (h2, c2))


def speller_step(p: Speller, x: torch.Tensor, state) -> tuple:
    """x: [B, enc_out + d]; returns (new_state, out [B, d])."""
    s1, s2 = state
    h1, c1 = rnn.lstm_step(p.layer_1, x, s1)
    h2, c2 = rnn.lstm_step(p.layer_2, h1, s2)
    return ((h1, c1), (h2, c2)), h2
