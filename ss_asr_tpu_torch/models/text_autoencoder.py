"""Text (denoising) autoencoder sharing the LAS speller, attention and embedding.

Port of ``ss_asr_tpu/models/text_autoencoder.py``.  A ``TextEncoder`` (char
embedding + stacked BiLSTMs -> [B, S, 2*state]) encodes the *noised* text;
decoding runs the ASR's own ``attend_and_spell`` over that memory, so
training the autoencoder trains the ASR's embed / attention / speller /
char_trans too.  ``TextAutoencoder.state_dict()`` has the reference's keys
(``export_tae`` in ``ss_asr_tpu/utils/torch_import.py``):
``encoder.emb.weight`` and ``encoder.blstm.{weight,bias}_{ih,hh}_l{i}[_reverse]``.

The BiLSTMs are ``rnn.bilstm`` (``LSTMSeq``: kernels K2 and K3 on the card)
with the noised lengths; the decode is ``SpellCore`` (K9 and K10) over a
memory of S = noised-text length.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops import rnn
from ss_asr_tpu_torch.vocab import VOCAB_SIZE


@dataclasses.dataclass(frozen=True)
class TAEConfig:
    vocab_size: int = VOCAB_SIZE
    emb_dim: int = 128
    state_size: int = 256
    num_layers: int = 2

    @classmethod
    def from_dict(cls, d: dict) -> "TAEConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class _Layer:
    """One layer of a ``BiLSTMStack``, read the way ``rnn.bilstm`` reads a
    ``rnn.BiLSTM``."""

    def __init__(self, stack: "BiLSTMStack", i: int):
        self.stack, self.i = stack, i

    def direction(self, reverse: bool):
        sfx = f"l{self.i}_reverse" if reverse else f"l{self.i}"
        s = self.stack
        return (getattr(s, f"weight_ih_{sfx}"), getattr(s, f"weight_hh_{sfx}"),
                getattr(s, f"bias_ih_{sfx}") + getattr(s, f"bias_hh_{sfx}"))


class BiLSTMStack(nn.Module):
    """Parameters of ``num_layers`` bidirectional LSTM layers, keyed like the
    reference ``nn.LSTM(num_layers=n, bidirectional=True)`` state_dict."""

    def __init__(self, in_dim: int, hidden: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            for sfx in (f"l{i}", f"l{i}_reverse"):
                for name, shape in (("weight_ih", (4 * hidden, in_dim)),
                                    ("weight_hh", (4 * hidden, hidden)),
                                    ("bias_ih", (4 * hidden,)), ("bias_hh", (4 * hidden,))):
                    self.register_parameter(f"{name}_{sfx}", nn.Parameter(torch.zeros(shape)))
            in_dim = 2 * hidden

    def layer(self, i: int) -> _Layer:
        return _Layer(self, i)


class TextEncoder(nn.Module):
    def __init__(self, cfg: TAEConfig):
        super().__init__()
        self.emb = nn.Embedding(cfg.vocab_size, cfg.emb_dim)
        self.blstm = BiLSTMStack(cfg.emb_dim, cfg.state_size, cfg.num_layers)


class TextAutoencoder(nn.Module):
    """The text autoencoder's own parameters (its decoder is the ASR's)."""

    def __init__(self, cfg: TAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = TextEncoder(cfg)


def text_encode(p: TextEncoder, y: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S] char ids -> [B, S, 2*state] memory."""
    x = rnn.embed(p.emb, y.long())
    if lengths is None:
        lengths = torch.full((y.shape[0],), y.shape[1], dtype=torch.int32, device=y.device)
    for i in range(p.blstm.num_layers):
        x = rnn.bilstm(p.blstm.layer(i), x, lengths)
    return x


def tae_forward(
    asr: las.LAS, tae: TextAutoencoder, y: torch.Tensor, y_noised: torch.Tensor,
    noise_lens: torch.Tensor, decode_step: int, tf_draws: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reconstruct the clean ``y`` [B, >= L+1] from ``y_noised`` ->
    ``(noise_lens, logits [B, L, V])``.  The scheduled-sampling draws are
    inputs, as in ``las.attend_and_spell``."""
    memory = text_encode(tae.encoder, y_noised, noise_lens)
    logits, _ = las.attend_and_spell(asr, memory, noise_lens, decode_step, teacher=y,
                                     tf_draws=tf_draws, gumbel=gumbel, tf_cutoff_last=True)
    return noise_lens, logits
