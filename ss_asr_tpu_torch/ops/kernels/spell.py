"""Attend-and-spell forward with teacher forcing / scheduled sampling: CUDA
kernel wrapper and its plain version.

Kernel: ``csrc/spell_fwd.cu`` (``ss_spell_fwd``), which replaces the TPU
kernel ``ss_asr_tpu/ops/pallas/spell.py::_fwd_kernel``.  The source's header
says what bounds it on an H100 and how its design answers that.

``spell_fwd`` routes by device: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs ``spell_fwd_plain``, the step loop in PyTorch ops
that the kernel is held against.  Both return the seven streams of the TPU
kernel, each ``[L, B, .]``: logits, attention weights, h1, c1, h2, c2 and
the embedding fed after each step.  The random numbers are inputs:
``tf_draws [L]`` (1 = feed the teacher at that step, one draw shared by the
batch) and ``gumbel [L, B, V]`` (noise added to the logits before the
sampling argmax); zero draws and zero noise give greedy feedback.

The backward (the TPU kernel ``_bwd_kernel``) is not ported yet: a CUDA
input that needs a gradient raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops import rnn
from ss_asr_tpu_torch.ops.kernels import build
from ss_asr_tpu_torch.ops.kernels.decode import kernel_operand, speller_operands
from ss_asr_tpu_torch.vocab import SOS_ID

#: kernel launches made by ``spell_fwd`` on CUDA tensors
LAUNCHES = {"spell_fwd": 0}

GRAD_TODO = ("ROADMAP.md port item 6 (the train step: the attend-and-spell backward "
             "kernel K10 and K9 as an autograd.Function)")

Streams = Tuple[torch.Tensor, ...]


def spell_fwd_plain(
    model: las.LAS, enc_h: torch.Tensor, comp_h: torch.Tensor, enc_lens: torch.Tensor,
    tf_draws: torch.Tensor, gumbel: torch.Tensor, teacher_emb: torch.Tensor,
) -> Streams:
    """The forward loop in plain PyTorch -> (logits, a, h1s, c1s, h2s, c2s, fed)."""
    B, S, _ = enc_h.shape
    L = tf_draws.shape[0]
    dev = enc_h.device
    valid = las.attention_mask(enc_lens.to(dev), S)
    state = las.speller_init_state(B, model.cfg, dev)
    sos = torch.full((B,), SOS_ID, dtype=torch.long, device=dev)
    fed = rnn.embed(model.embed, sos)
    outs = [[] for _ in range(7)]
    for t in range(L):
        a, context = las.attention_step(model.attention, comp_h, enc_h, state[0][0], valid)
        state, dec_out = las.speller_step(model.decoder, torch.cat([fed, context], -1), state)
        logits = rnn.linear(model.char_trans, dec_out)
        sampled = torch.argmax(logits + gumbel[t], dim=-1)
        fed = teacher_emb[t] if bool(tf_draws[t] > 0.5) else rnn.embed(model.embed, sampled)
        (h1, c1), (h2, c2) = state
        for o, v in zip(outs, (logits, a, h1, c1, h2, c2, fed)):
            o.append(v)
    return tuple(torch.stack(o) for o in outs)


def spell_fwd(
    model: las.LAS, enc_h: torch.Tensor, comp_h: torch.Tensor, enc_lens: torch.Tensor,
    tf_draws: torch.Tensor, gumbel: torch.Tensor, teacher_emb: torch.Tensor,
) -> Streams:
    """Attend-and-spell forward over L = len(tf_draws) steps.

    enc_h [B, S, F], comp_h [B, S, M], enc_lens [B] (clamped to >= 1 here),
    tf_draws [L], gumbel [L, B, V], teacher_emb [L, B, H] (the embedding to
    feed after step t when the draw says teacher).  Returns
    ``(logits [L,B,V], a [L,B,S], h1s, c1s, h2s, c2s [L,B,H], fed [L,B,H])``."""
    B, S, F = enc_h.shape
    cfg = model.cfg
    H, M, V = cfg.decoder_state_size, cfg.mlp_out_size, cfg.vocab_size
    L = tf_draws.shape[0]
    if (F != cfg.enc_out_dim or comp_h.shape != (B, S, M) or enc_lens.shape != (B,) or S < 1
            or gumbel.shape != (L, B, V) or teacher_emb.shape != (L, B, H)):
        raise ValueError(
            f"spell_fwd: enc_h {tuple(enc_h.shape)}, comp_h {tuple(comp_h.shape)}, "
            f"enc_lens {tuple(enc_lens.shape)}, tf_draws {tuple(tf_draws.shape)}, gumbel "
            f"{tuple(gumbel.shape)}, teacher_emb {tuple(teacher_emb.shape)} do not fit {cfg}")
    if enc_h.device.type == "cpu":
        return spell_fwd_plain(model, enc_h, comp_h, enc_lens, tf_draws, gumbel, teacher_emb)
    dev = enc_h.device
    if dev.type != "cuda":
        raise ValueError(f"spell_fwd: no kernel for device {dev}")
    inputs = (enc_h, comp_h, gumbel, teacher_emb, *model.parameters())
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(
            f"spell_fwd: the CUDA kernel has no backward yet, see {GRAD_TODO}; "
            "call it under torch.no_grad() or torch.inference_mode()")
    ins = [kernel_operand(t, dev) for t in (enc_h, comp_h)]
    lens = torch.clamp(enc_lens.to(device=dev, dtype=torch.int32), min=1).contiguous()
    ins += [lens] + [kernel_operand(t.to(torch.float32), dev)
                     for t in (tf_draws, gumbel, teacher_emb)]
    outs = [torch.empty(L, B, n, dtype=torch.float32, device=dev) for n in (V, S, H, H, H, H, H)]
    if B == 0 or L == 0:
        return tuple(outs)
    lib = build.load_library()
    err = lib.ss_spell_fwd(
        *[t.data_ptr() for t in ins], *[w.data_ptr() for w in speller_operands(model, dev)],
        *[o.data_ptr() for o in outs], B, S, F, M, H, V, L, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "ss_spell_fwd")
    build.count_launch(LAUNCHES, "spell_fwd")
    return tuple(outs)
