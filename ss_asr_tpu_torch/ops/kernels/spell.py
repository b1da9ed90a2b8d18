"""Attend-and-spell with teacher forcing / scheduled sampling, forward and
backward: CUDA kernel wrappers, their plain versions, and the autograd
function over both.

Kernels: ``csrc/spell_fwd.cu`` (``ss_spell_fwd``), which replaces the TPU
kernel ``ss_asr_tpu/ops/pallas/spell.py::_fwd_kernel``, and
``csrc/spell_bwd.cu`` (``ss_spell_bwd``), which replaces ``::_bwd_kernel``.
The sources' headers say what bounds them on an H100 and how their design
answers that.

``spell_fwd`` and ``spell_bwd`` route by device: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs ``spell_fwd_plain`` /
``spell_bwd_plain``, the step loops in PyTorch ops that the kernels are held
against.  The forward returns the seven streams of the TPU kernel, each
``[L, B, .]``: logits, attention weights, h1, c1, h2, c2 and the embedding
fed after each step.  The random numbers are inputs: ``tf_draws [L]`` (1 =
feed the teacher at that step, one draw shared by the batch) and ``gumbel
[L, B, V]`` (noise added to the logits before the sampling argmax); zero
draws and zero noise give greedy feedback.

``SpellCore`` is the differentiable loop (the port of ``_spell_core`` /
``_spell_fwd`` / ``_spell_bwd``): its forward is ``spell_fwd``, its backward
``spell_bwd`` plus the weight, encoder and embedding gradients as batched
products outside the kernel.  The kernels write through raw pointers, so a
direct ``spell_fwd`` call on CUDA tensors that need a gradient raises.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops import rnn
from ss_asr_tpu_torch.ops.kernels import build
from ss_asr_tpu_torch.ops.kernels.decode import kernel_operand, speller_operands
from ss_asr_tpu_torch.vocab import SOS_ID

#: kernel launches made by ``spell_fwd`` / ``spell_bwd`` on CUDA tensors
LAUNCHES = {"spell_fwd": 0, "spell_bwd": 0}

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
    state = las.speller_init_state(B, model.cfg, dev, enc_h.dtype)
    sos = torch.full((B,), SOS_ID, dtype=torch.long, device=dev)
    fed = rnn.embed(model.embed, sos)
    outs = [[] for _ in range(7)]
    for t in range(L):
        a, context = las.attention_step(model.attention, comp_h, enc_h, state[0][0], valid)
        state, dec_out = las.speller_step(model.decoder, torch.cat([fed, context], -1), state)
        logits = rnn.linear(model.char_trans, dec_out)
        sampled = torch.argmax(logits + gumbel[t], dim=-1)
        fed = torch.where(tf_draws[t] > 0.5, teacher_emb[t], rnn.embed(model.embed, sampled))
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
    ``(logits [L,B,V], a [L,B,S], h1s, c1s, h2s, c2s [L,B,H], fed [L,B,H])``.
    Differentiate through ``SpellCore``."""
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
        raise RuntimeError("spell_fwd: the CUDA kernel is invisible to autograd; "
                           "differentiate through SpellCore.apply (las.attend_and_spell does)")
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


def shifted(streams: Streams, emb: torch.Tensor) -> Streams:
    """The forward's state entering each step: ``(h1p, c1p, h2p, c2p,
    fedp)``, each the stream one step later (zero state first), and the
    embedding fed into each step (SOS's first)."""
    _, h1s, c1s, h2s, c2s, fed = streams
    sos = emb[SOS_ID].expand(1, *fed.shape[1:])
    return tuple(torch.cat([torch.zeros_like(s[:1]), s[:-1]]) for s in (h1s, c1s, h2s, c2s)) + (
        torch.cat([sos, fed[:-1]]),)


def _gate_acts(gates: torch.Tensor, H: int) -> Streams:
    return (torch.sigmoid(gates[..., :H]), torch.sigmoid(gates[..., H:2 * H]),
            torch.tanh(gates[..., 2 * H:3 * H]), torch.sigmoid(gates[..., 3 * H:]))


def _cell_adjoint(dh, dc, acts, tanh_c, c_p):
    """One LSTM cell's adjoint -> (dgates [B, 4H], dc carry)."""
    i, f, g, o = acts
    dct = dh * o * (1.0 - tanh_c * tanh_c) + dc
    return torch.cat([dct * g * i * (1.0 - i), dct * c_p * f * (1.0 - f),
                      dct * i * (1.0 - g * g), dh * tanh_c * o * (1.0 - o)], -1), dct * f


def spell_bwd_plain(
    enc_h: torch.Tensor, comp_h: torch.Tensor, dlogits: torch.Tensor, daext: torch.Tensor,
    streams: Streams, W: Sequence[torch.Tensor],
) -> Streams:
    """The backward loop in plain PyTorch -> ``(dg1, dg2 [L,B,4H], de [L,B,S],
    dqp [L,B,M], demb [L,B,H])``: the TPU kernel ``_bwd_kernel``, with the
    forward's gates recomputed for all steps at once."""
    phi, wih1, whh1, b1, wih2, whh2, b2, ct_w, _, emb = W
    a, h1s, c1s, h2s, c2s, _ = streams
    h1p, c1p, h2p, c2p, fedp = shifted(streams, emb)
    L, B, H = h1s.shape
    E = fedp.shape[-1]
    q = torch.tanh(h1p @ phi)
    ctx = torch.einsum("lbs,bsf->lbf", a, enc_h)
    acts1 = _gate_acts(torch.cat([fedp, ctx], -1) @ wih1 + h1p @ whh1 + b1, H)
    acts2 = _gate_acts(h1s @ wih2 + h2p @ whh2 + b2, H)
    tanh_c1, tanh_c2 = torch.tanh(c1s), torch.tanh(c2s)
    dh1c, dc1c, dh2c, dc2c = (h1s.new_zeros(B, H) for _ in range(4))
    outs = [[] for _ in range(5)]
    for t in range(L - 1, -1, -1):
        dh2 = dh2c + dlogits[t] @ ct_w.t()
        dg2, dc2c = _cell_adjoint(dh2, dc2c, [x[t] for x in acts2], tanh_c2[t], c2p[t])
        dh2c = dg2 @ whh2.t()
        dh1 = dh1c + dg2 @ wih2.t()
        dg1, dc1c = _cell_adjoint(dh1, dc1c, [x[t] for x in acts1], tanh_c1[t], c1p[t])
        dx = dg1 @ wih1.t()
        da = torch.einsum("bsf,bf->bs", enc_h, dx[:, E:]) + daext[t]
        ada = a[t] * da
        de = ada - a[t] * ada.sum(-1, keepdim=True)
        dqp = torch.einsum("bsm,bs->bm", comp_h, de) * (1.0 - q[t] * q[t])
        dh1c = dg1 @ whh1.t() + dqp @ phi.t()
        for o, v in zip(outs, (dg1, dg2, de, dqp, dx[:, :E])):
            o.append(v)
    return tuple(torch.stack(o[::-1]) for o in outs)


def spell_bwd(
    enc_h: torch.Tensor, comp_h: torch.Tensor, dlogits: torch.Tensor, daext: torch.Tensor,
    streams: Streams, W: Sequence[torch.Tensor],
) -> Streams:
    """Adjoint of the attend-and-spell loop -> ``(dg1, dg2, de, dqp, demb)``
    (shapes in ``spell_bwd_plain``).  dlogits [L, B, V] and daext [L, B, S]
    are the cotangents of the logits and attention maps; ``streams`` are
    ``spell_fwd``'s (a, h1s, c1s, h2s, c2s, fed); W the speller weights in
    ``x @ W`` layout (``decode.speller_weights``)."""
    a, h1s = streams[0], streams[1]
    L, B, S = a.shape
    H, F = h1s.shape[2], enc_h.shape[2]
    M, V = W[0].shape[1], W[7].shape[1]
    if (enc_h.shape != (B, S, F) or comp_h.shape != (B, S, M) or dlogits.shape != (L, B, V)
            or daext.shape != (L, B, S) or W[1].shape != (H + F, 4 * H)):
        raise ValueError(
            f"spell_bwd: enc_h {tuple(enc_h.shape)}, comp_h {tuple(comp_h.shape)}, dlogits "
            f"{tuple(dlogits.shape)}, daext {tuple(daext.shape)} do not fit the streams "
            f"[L={L}, B={B}, S={S}, H={H}]")
    if enc_h.device.type == "cpu":
        return spell_bwd_plain(enc_h, comp_h, dlogits, daext, streams, W)
    dev = enc_h.device
    if dev.type != "cuda":
        raise ValueError(f"spell_bwd: no kernel for device {dev}")
    ins = [kernel_operand(t.detach(), dev)
           for t in (enc_h, comp_h, dlogits, daext, *streams, *W[:8], W[9])]
    outs = [torch.empty(L, B, n, dtype=torch.float32, device=dev)
            for n in (4 * H, 4 * H, S, M, H)]
    if B == 0 or L == 0:
        return tuple(outs)
    lib = build.load_library()
    err = lib.ss_spell_bwd(
        *[t.data_ptr() for t in ins], *[o.data_ptr() for o in outs], B, S, F, M, H, V, L,
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "ss_spell_bwd")
    build.count_launch(LAUNCHES, "spell_bwd")
    return tuple(outs)


class SpellCore(torch.autograd.Function):
    """Differentiable attend-and-spell: ``SpellCore.apply(model, enc_h,
    comp_h, enc_lens, tf_draws, gumbel, teacher_emb, *W) -> (logits [L, B,
    V], a [L, B, S])`` with the inputs of ``spell_fwd``; ``W`` is
    ``decode.speller_weights(model)``, the same weights as autograd views of
    the parameters, through which their gradients reach the modules.

    Gradients flow to enc_h, comp_h, teacher_emb and W.  The embedding fed
    into step t was emb[SOS] at t = 0, else teacher_emb[t-1] where
    tf_draws[t-1] is 1 and the table row of the sampled id (the first
    argmax of logits + gumbel, recomputed here) where it is 0; demb routes
    along the same choice.  No gradient passes through the argmax."""

    @staticmethod
    def forward(ctx, model, enc_h, comp_h, enc_lens, tf_draws, gumbel, teacher_emb, *W):
        streams = spell_fwd(model, enc_h, comp_h, enc_lens, tf_draws, gumbel, teacher_emb)
        ctx.save_for_backward(enc_h, comp_h, tf_draws, gumbel, *streams, *W)
        return streams[0], streams[1]

    @staticmethod
    def backward(ctx, dlogits, da_ext):
        enc_h, comp_h, tf_draws, gumbel, logits, *rest = ctx.saved_tensors
        streams, W = tuple(rest[:6]), rest[6:]
        phi, wih1, whh1, b1, wih2, whh2, b2, ct_w, ct_b, emb = W
        a, h1s = streams[0], streams[1]
        if da_ext is None:  # a loss that reads no attention map
            da_ext = torch.zeros_like(a)
        dlogits = torch.zeros_like(logits) if dlogits is None else dlogits.contiguous()
        dg1, dg2, de, dqp, demb = spell_bwd(enc_h, comp_h, dlogits, da_ext, streams, W)
        h1p, _, h2p, _, fedp = shifted(streams, emb)
        _, B, E = fedp.shape
        V = ct_w.shape[1]
        ctx_ = torch.einsum("lbs,bsf->lbf", a, enc_h)
        x = torch.cat([fedp, ctx_], -1)
        grads_w = (
            torch.einsum("lbh,lbm->hm", h1p, dqp),                  # phi
            torch.einsum("lbx,lbg->xg", x, dg1),                    # W_ih1
            torch.einsum("lbh,lbg->hg", h1p, dg1), dg1.sum((0, 1)),  # W_hh1, b1
            torch.einsum("lbh,lbg->hg", h1s, dg2),                  # W_ih2
            torch.einsum("lbh,lbg->hg", h2p, dg2), dg2.sum((0, 1)),  # W_hh2, b2
            torch.einsum("lbh,lbv->hv", streams[3], dlogits), dlogits.sum((0, 1)),  # ct_w, ct_b
        )
        q = torch.tanh(h1p @ phi)
        d_comp = torch.einsum("lbs,lbm->bsm", de, q)
        d_enc = torch.einsum("lbs,lbf->bsf", a, dg1 @ wih1[E:].t())
        # the feedback: the table row fed into step t (SOS, or a sampled id)
        sampled = torch.argmax(logits + gumbel, dim=-1)
        ids_prev = torch.cat([torch.full_like(sampled[:1], SOS_ID), sampled[:-1]])
        tf_prev = torch.cat([tf_draws.new_zeros(1), tf_draws[:-1]])
        sel = torch.nn.functional.one_hot(ids_prev, V).to(demb.dtype)
        sel = sel * (1.0 - tf_prev)[:, None, None]
        d_emb = torch.einsum("lbv,lbe->ve", sel, demb)
        d_teacher = torch.cat([demb[1:] * tf_draws[:-1, None, None], demb.new_zeros(1, B, E)])
        return (None, d_enc, d_comp, None, None, None, d_teacher) + grads_w + (d_emb,)
