"""The packed LSTM time loop: CUDA kernel wrapper and its plain version.

Kernel: ``csrc/lstm_fwd.cu`` (``ss_lstm_fwd``), which replaces the TPU
kernel ``ss_asr_tpu/ops/pallas/lstm.py::_make_fwd_kernel`` and runs both
directions of a BiLSTM layer in one launch.  The source's header says what
bounds it on an H100 and how its design answers that.

``lstm_fwd`` routes by device: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs ``lstm_seq_plain``, the time loop in PyTorch ops
that the kernel is held against.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ss_asr_tpu_torch.ops.kernels import build

#: kernel launches made by ``lstm_fwd`` (one per call on a CUDA tensor)
LAUNCHES = {"lstm_fwd": 0}


def lstm_seq_plain(
    gx: torch.Tensor, whh: torch.Tensor, lengths: torch.Tensor, reverse: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed LSTM loop in plain PyTorch.

    gx [T, B, 4H] time-major ``x @ W_ih + b``; whh [H, 4H] (``x @ W``
    layout); lengths [B].  Returns ``(y, cs)``, both [T, B, H]: ``y`` is
    zero past each length, ``cs`` is the (frozen) cell carry after each
    step.  ``reverse`` walks t = T-1 .. 0."""
    T, B, G = gx.shape
    H = G // 4
    h = gx.new_zeros(B, H)
    c = gx.new_zeros(B, H)
    y = gx.new_zeros(T, B, H)
    cs = gx.new_zeros(T, B, H)
    lengths = lengths.to(gx.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        i, f, g, o = (gx[t] + h @ whh).chunk(4, dim=-1)
        c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h2 = torch.sigmoid(o) * torch.tanh(c2)
        valid = (t < lengths)[:, None]
        h = torch.where(valid, h2, h)
        c = torch.where(valid, c2, c)
        y[t] = torch.where(valid, h2, torch.zeros_like(h2))
        cs[t] = c
    return y, cs


def lstm_fwd(
    gx: torch.Tensor, whh: torch.Tensor, lengths: torch.Tensor, reverse: Sequence[bool]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """D independent packed LSTM loops (D = directions of a layer).

    gx [D, T, B, 4H] float32; whh [D, H, 4H] float32; lengths [B];
    ``reverse[d]`` makes direction d walk time newest-first.  Returns
    ``(y, cs)``, each [D, T, B, H]."""
    D, T, B, G = gx.shape
    H = G // 4
    if whh.shape != (D, H, G) or len(reverse) != D or lengths.shape != (B,):
        raise ValueError(
            f"lstm_fwd: gx {tuple(gx.shape)}, whh {tuple(whh.shape)}, "
            f"lengths {tuple(lengths.shape)}, {len(reverse)} directions")
    if gx.device.type == "cpu":
        outs = [lstm_seq_plain(gx[d], whh[d], lengths, reverse[d]) for d in range(D)]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    if gx.device.type != "cuda":
        raise ValueError(f"lstm_fwd: no kernel for device {gx.device}")
    for name, t in (("gx", gx), ("whh", whh)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != gx.device:
            raise ValueError(f"lstm_fwd: {name} must be contiguous float32 on {gx.device}")
    lengths = lengths.to(device=gx.device, dtype=torch.int32).contiguous()
    y = torch.empty(D, T, B, H, device=gx.device, dtype=torch.float32)
    cs = torch.empty_like(y)
    if T == 0 or B == 0:
        return y, cs
    lib = build.load_library()
    rev_bits = sum(1 << d for d in range(D) if reverse[d])
    err = lib.ss_lstm_fwd(
        gx.data_ptr(), whh.data_ptr(), lengths.data_ptr(), y.data_ptr(), cs.data_ptr(),
        D, T, B, H, rev_bits, gx.device.index or 0,
        torch.cuda.current_stream(gx.device).cuda_stream,
    )
    build.check(err, "ss_lstm_fwd")
    LAUNCHES["lstm_fwd"] += 1
    return y, cs
