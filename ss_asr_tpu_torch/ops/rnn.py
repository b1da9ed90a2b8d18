"""Recurrent cells and the packed BiLSTM, as functions on tensors.

Port of ``ss_asr_tpu/ops/rnn.py``.  Parameters live in ``nn.Module``s keyed
like the reference PyTorch state_dicts (torch layout: ``weight [out, in]``,
LSTM/GRU gate blocks stacked on dim 0, gate order LSTM i,f,g,o and GRU
r,z,n — the same order the JAX package uses), and the functions here read
them the way the JAX functions read their parameter dicts.

Packed-sequence semantics, as in JAX: past each sample's length the carry
freezes and the output is zero; the backward direction walks time
newest-first per sample (padding first, on the zero carry), which equals
reversing each sample by its own length.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ss_asr_tpu_torch.ops.kernels.lstm import lstm_fwd, lstm_seq_plain


def linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p.weight, p.bias)


def embed(p: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    return p.weight[ids]


def _lstm_gates(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_step(
    p: nn.LSTMCell, x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step: x [B, in], state ([B,H],[B,H]) -> new (h, c)."""
    h, c = state
    gates = x @ p.weight_ih.t() + h @ p.weight_hh.t() + (p.bias_ih + p.bias_hh)
    return _lstm_gates(gates, c)


def gru_step(p: nn.GRUCell, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step (torch GRUCell semantics): x [B,in], h [B,H] -> h'."""
    gi = F.linear(x, p.weight_ih, p.bias_ih)
    gh = F.linear(h, p.weight_hh, p.bias_hh)
    H = h.shape[-1]
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H : 2 * H] + gh[:, H : 2 * H])
    n = torch.tanh(gi[:, 2 * H :] + r * gh[:, 2 * H :])
    return (1.0 - z) * n + z * h


class BiLSTM(nn.Module):
    """Parameters of one bidirectional LSTM layer, keyed like the
    reference ``nn.LSTM(bidirectional=True)`` state_dict (``*_l0`` forward,
    ``*_l0_reverse`` backward).  The recurrence itself is ``bilstm`` below;
    no cuDNN LSTM runs."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hidden_size = hidden
        for sfx in ("l0", "l0_reverse"):
            self.register_parameter(f"weight_ih_{sfx}", nn.Parameter(torch.zeros(4 * hidden, in_dim)))
            self.register_parameter(f"weight_hh_{sfx}", nn.Parameter(torch.zeros(4 * hidden, hidden)))
            self.register_parameter(f"bias_ih_{sfx}", nn.Parameter(torch.zeros(4 * hidden)))
            self.register_parameter(f"bias_hh_{sfx}", nn.Parameter(torch.zeros(4 * hidden)))

    def direction(self, reverse: bool):
        """(weight_ih [4H,in], weight_hh [4H,H], merged bias [4H])."""
        sfx = "l0_reverse" if reverse else "l0"
        return (getattr(self, f"weight_ih_{sfx}"), getattr(self, f"weight_hh_{sfx}"),
                getattr(self, f"bias_ih_{sfx}") + getattr(self, f"bias_hh_{sfx}"))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        return bilstm(self, x, lengths)


def input_gates(x: torch.Tensor, w_ih: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Time-major input projection ``x @ W_ih + b``: [B,T,in] -> [T,B,4H].

    One large matmul outside the recurrence, as JAX computes it outside
    the LSTM kernel (ops/pallas/lstm.py ``lstm_scan_pallas_trainable``)."""
    B, T, Fi = x.shape
    x_tm = x.transpose(0, 1).reshape(T * B, Fi)
    return torch.addmm(b, x_tm, w_ih.t()).view(T, B, -1)


def lstm_scan(
    p: BiLSTM, x: torch.Tensor, lengths: Optional[torch.Tensor] = None, reverse: bool = False
) -> torch.Tensor:
    """One direction of ``p`` over [B, T, in] -> [B, T, H], plain PyTorch.

    The port of JAX ``rnn.lstm_scan(...)[0]`` (the final carry is not
    returned: nothing on the serving path reads it)."""
    B, T, _ = x.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=x.device)
    w_ih, w_hh, b = p.direction(reverse)
    y, _ = lstm_seq_plain(input_gates(x, w_ih, b), w_hh.t(), lengths, reverse=reverse)
    return y.transpose(0, 1)


def bilstm(p: BiLSTM, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Bidirectional packed LSTM: [B, T, in] -> [B, T, 2H].

    Both directions run in ONE call of the LSTM kernel wrapper (a grid
    dimension per direction on the card; the plain loop per direction on
    the CPU)."""
    gx, whh = [], []
    for reverse in (False, True):
        w_ih, w_hh, b = p.direction(reverse)
        gx.append(input_gates(x, w_ih, b))
        whh.append(w_hh.t())
    y, _ = lstm_fwd(torch.stack(gx), torch.stack(whh), lengths, (False, True))
    # [2, T, B, H] -> [B, T, 2H]
    return torch.cat([y[0], y[1]], dim=-1).transpose(0, 1)


def downsample_time(
    x: torch.Tensor, lengths: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pyramidal 2x time reduction: [B, T, F] -> [B, T//2, 2F]; the odd
    trailing frame is dropped and lengths halve by integer division."""
    B, T, Fi = x.shape
    T2 = (T // 2) * 2
    return x[:, :T2].reshape(B, T2 // 2, 2 * Fi), torch.div(lengths, 2, rounding_mode="floor")
