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
fed after each step; with ``with_gates`` also the two cells' gate
pre-activations ``[L, B, 4H]``, which ``spell_bwd`` takes instead of
recomputing them.  The random numbers are inputs: ``tf_draws [L]`` (1 =
feed the teacher at that step, one draw shared by the batch) and ``gumbel
[L, B, V]`` (noise added to the logits before the sampling argmax); zero
draws and zero noise give greedy feedback.

On the card both kernels have two routes, which ``spell_route`` picks from
the shape alone: the cluster route (a thread-block cluster of H / 32 CTAs
per tile of R batch rows, each CTA streaming its 128 gate columns of the
cell weights once a step for all R rows; ``LAUNCHES["spell_fwd_cluster"]``
/ ``["spell_bwd_cluster"]`` count it) and, for shapes it does not serve,
the one-row kernels (a block per batch row).  On the cluster route the
forward writes the gates and the backward needs them.

``SpellCore`` is the differentiable loop (the port of ``_spell_core`` /
``_spell_fwd`` / ``_spell_bwd``): its forward is ``spell_fwd``, its backward
``spell_bwd`` plus the weight, encoder and embedding gradients as batched
products outside the kernel.  The kernels write through raw pointers, so a
direct ``spell_fwd`` call on CUDA tensors that need a gradient raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops import rnn
from ss_asr_tpu_torch.ops.kernels import build
from ss_asr_tpu_torch.ops.kernels.decode import kernel_operand, speller_operands
from ss_asr_tpu_torch.ops.kernels.lstm import SMEM_BYTES
from ss_asr_tpu_torch.ops.kernels.speller_cluster import (SP_COLS, SP_THREADS, SP_UNITS, SP_WARPS,
                                                          cluster_shape_serves, r4, tile_route)
from ss_asr_tpu_torch.vocab import SOS_ID

#: kernel launches made by ``spell_fwd`` / ``spell_bwd`` on CUDA tensors;
#: ``spell_fwd_cluster`` / ``spell_bwd_cluster`` count those that took the
#: cluster route
LAUNCHES = {"spell_fwd": 0, "spell_fwd_cluster": 0, "spell_bwd": 0, "spell_bwd_cluster": 0}

Streams = Tuple[torch.Tensor, ...]

#: the tile heights (batch rows a cluster) the cluster routes are written for
TILE_ROWS = (4, 5, 6, 8)


def spell_fwd_smem_bytes(H: int, F: int, M: int, S: int, V: int, R: int) -> int:
    """Shared memory of one CTA of K9's cluster route (``fwd_plan`` in
    ``csrc/spell_fwd.cu``): h1 and h2 double-buffered, the fed embedding, the
    gathered context, query and energies, the own cell carries, the warps'
    gate partials, the small products' partials, the own columns' gates, the
    logits and the step's noise, the resident ct_w, ct_b, phi's own columns
    and the own columns' biases, and three [R] index arrays."""
    Mc = M // (H // 32)
    floats = (2 * r4(2 * R * H) + r4(R * H) + r4(R * F) + r4(R * M) + r4(R * S)
              + 2 * r4(R * SP_UNITS) + r4(SP_WARPS * R * SP_COLS)
              + r4(SP_THREADS * max(R, 4)) + R * SP_COLS + 2 * r4(R * V) + r4(H * V) + r4(V)
              + r4(H * Mc) + 2 * SP_COLS + 3 * r4(R))
    return 4 * floats


def _tprod_floats(K: int, R: int) -> int:
    return max(1, SP_THREADS // (K // 4)) * R * K


def spell_bwd_smem_bytes(H: int, F: int, M: int, S: int, V: int, R: int) -> int:
    """Shared memory of one CTA of K10's cluster route (``bwd_plan`` in
    ``csrc/spell_bwd.cu``): the step's dlogits, attention weights and their
    cotangent, h1 entering the step, the own query columns and dqpre, the own
    gate cotangents, the four carries, the own context columns' cotangent,
    the transposed products' partials, the small products' partials, the
    four reduce-scatter slot arrays that every CTA of the cluster writes,
    the resident own rows of ct_w and own columns of phi, and the step's
    gates, cell states and daext at the own units."""
    C = H // 32
    Fc, Mc = F // C, M // C
    floats = (r4(R * V) + 2 * r4(R * S) + r4(R * H) + 2 * r4(R * Mc) + r4(R * SP_COLS)
              + r4(4 * R * SP_UNITS) + r4(R * Fc)
              + r4(max(_tprod_floats(2 * H + F, R), _tprod_floats(2 * H, R)))
              + r4(SP_THREADS * max(R, 4)) + r4(C * R * 2 * SP_UNITS)
              + r4(C * R * (2 * SP_UNITS + Fc)) + r4(C * R * S) + r4(C * R * SP_UNITS)
              + r4(SP_UNITS * V) + r4(H * (Mc + 1)) + 2 * R * SP_COLS + 4 * R * SP_UNITS
              + r4(R * S) + r4(R))
    return 4 * floats


def cluster_serves(H: int, F: int, M: int, S: int, V: int, R: int) -> bool:
    """Whether the cluster route of both kernels serves this shape with tiles
    of R rows: ``cluster_shape_serves``, and both CTAs' buffers inside one
    block's shared memory."""
    return (R in TILE_ROWS and cluster_shape_serves(H, F, M, S, V)
            and spell_fwd_smem_bytes(H, F, M, S, V, R) <= SMEM_BYTES
            and spell_bwd_smem_bytes(H, F, M, S, V, R) <= SMEM_BYTES)


def spell_route(B: int, H: int, F: int, M: int, S: int, V: int) -> int:
    """The route of ``spell_fwd`` and ``spell_bwd`` on the card, from the
    shape alone -> R: the cluster route with tiles of R batch rows (clusters
    of H / 32 CTAs), R the smallest of 4, 5, 6, 8 that serves and whose
    clusters are all resident at once on the card (15 clusters of 8 CTAs:
    B = 16 or 32 take tiles of 4 rows, the TAE's B = 64 tiles of 5), else
    the largest that serves; or 0, the one-row kernels, where none serves
    (H not a multiple of 32, H above 256, or buffers past shared memory)."""
    return tile_route(B, H, [R for R in TILE_ROWS if cluster_serves(H, F, M, S, V, R)])


def spell_fwd_plain(
    model: las.LAS, enc_h: torch.Tensor, comp_h: torch.Tensor, enc_lens: torch.Tensor,
    tf_draws: torch.Tensor, gumbel: torch.Tensor, teacher_emb: torch.Tensor,
    with_gates: bool = False,
) -> Streams:
    """The forward loop in plain PyTorch -> (logits, a, h1s, c1s, h2s, c2s,
    fed), and with ``with_gates`` also the gate pre-activations (g1s, g2s)
    [L, B, 4H] of the two cells."""
    B, S, _ = enc_h.shape
    L = tf_draws.shape[0]
    dev = enc_h.device
    valid = las.attention_mask(enc_lens.to(dev), S)
    state = las.speller_init_state(B, model.cfg, dev, enc_h.dtype)
    sos = torch.full((B,), SOS_ID, dtype=torch.long, device=dev)
    fed = rnn.embed(model.embed, sos)
    cells = (model.decoder.layer_1, model.decoder.layer_2)
    outs = [[] for _ in range(9 if with_gates else 7)]
    for t in range(L):
        a, context = las.attention_step(model.attention, comp_h, enc_h, state[0][0], valid)
        x = torch.cat([fed, context], -1)
        h_prev = (state[0][0], state[1][0])
        state, dec_out = las.speller_step(model.decoder, x, state)
        # the cells' gate pre-activations, as the kernels form them
        gates = [xin @ cell.weight_ih.t() + h @ cell.weight_hh.t() + (cell.bias_ih + cell.bias_hh)
                 for cell, xin, h in zip(cells, (x, state[0][0]), h_prev)] if with_gates else []
        logits = rnn.linear(model.char_trans, dec_out)
        sampled = torch.argmax(logits + gumbel[t], dim=-1)
        fed = torch.where(tf_draws[t] > 0.5, teacher_emb[t], rnn.embed(model.embed, sampled))
        (h1, c1), (h2, c2) = state
        for o, v in zip(outs, (logits, a, h1, c1, h2, c2, fed, *gates)):
            o.append(v)
    return tuple(torch.stack(o) for o in outs)


def spell_fwd(
    model: las.LAS, enc_h: torch.Tensor, comp_h: torch.Tensor, enc_lens: torch.Tensor,
    tf_draws: torch.Tensor, gumbel: torch.Tensor, teacher_emb: torch.Tensor,
    with_gates: bool = False, route: Optional[int] = None,
) -> Streams:
    """Attend-and-spell forward over L = len(tf_draws) steps.

    enc_h [B, S, F], comp_h [B, S, M], enc_lens [B] (clamped to >= 1 here),
    tf_draws [L], gumbel [L, B, V], teacher_emb [L, B, H] (the embedding to
    feed after step t when the draw says teacher).  Returns
    ``(logits [L,B,V], a [L,B,S], h1s, c1s, h2s, c2s [L,B,H], fed [L,B,H])``
    and, with ``with_gates``, ``(g1s, g2s)`` [L, B, 4H] after them: the gate
    pre-activations, which the one-row kernel does not write (``None`` on
    that route; ``spell_bwd`` recomputes them there).  ``route`` overrides
    ``spell_route`` on the card (tests).  Differentiate through
    ``SpellCore``."""
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
        return spell_fwd_plain(model, enc_h, comp_h, enc_lens, tf_draws, gumbel, teacher_emb,
                               with_gates)
    dev = enc_h.device
    if dev.type != "cuda":
        raise ValueError(f"spell_fwd: no kernel for device {dev}")
    inputs = (enc_h, comp_h, gumbel, teacher_emb, *model.parameters())
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError("spell_fwd: the CUDA kernel is invisible to autograd; "
                           "differentiate through SpellCore.apply (las.attend_and_spell does)")
    R = spell_route(B, H, F, M, S, V) if route is None else route
    ins = [kernel_operand(t, dev) for t in (enc_h, comp_h)]
    lens = torch.clamp(enc_lens.to(device=dev, dtype=torch.int32), min=1).contiguous()
    ins += [lens] + [kernel_operand(t.to(torch.float32), dev)
                     for t in (tf_draws, gumbel, teacher_emb)]
    outs = [torch.empty(L, B, n, dtype=torch.float32, device=dev) for n in (V, S, H, H, H, H, H)]
    gates = ([torch.empty(L, B, 4 * H, dtype=torch.float32, device=dev) for _ in range(2)]
             if with_gates and R else [None, None])
    result = tuple(outs) + (tuple(gates) if with_gates else ())
    if B == 0 or L == 0:
        return result
    lib = build.load_library()
    err = lib.ss_spell_fwd(
        *[t.data_ptr() for t in ins], *[w.data_ptr() for w in speller_operands(model, dev)],
        *[o.data_ptr() for o in outs], *[g.data_ptr() if g is not None else None for g in gates],
        B, S, F, M, H, V, L, R, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "ss_spell_fwd")
    build.count_launch(LAUNCHES, "spell_fwd")
    if R:
        build.count_launch(LAUNCHES, "spell_fwd_cluster")
    return result


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
    gates: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Streams:
    """The backward loop in plain PyTorch -> ``(dg1, dg2 [L,B,4H], de [L,B,S],
    dqp [L,B,M], demb [L,B,H])``: the TPU kernel ``_bwd_kernel``.  The
    forward's gates are ``gates`` (g1s, g2s) where given (the forward's
    ``with_gates`` output), else recomputed for all steps at once."""
    phi, wih1, whh1, b1, wih2, whh2, b2, ct_w, _, emb = W
    a, h1s, c1s, h2s, c2s, _ = streams
    h1p, c1p, h2p, c2p, fedp = shifted(streams, emb)
    L, B, H = h1s.shape
    E = fedp.shape[-1]
    q = torch.tanh(h1p @ phi)
    if gates is None:
        ctx = torch.einsum("lbs,bsf->lbf", a, enc_h)
        gates = (torch.cat([fedp, ctx], -1) @ wih1 + h1p @ whh1 + b1,
                 h1s @ wih2 + h2p @ whh2 + b2)
    acts1, acts2 = (_gate_acts(g, H) for g in gates)
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
    gates: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, route: Optional[int] = None,
) -> Streams:
    """Adjoint of the attend-and-spell loop -> ``(dg1, dg2, de, dqp, demb)``
    (shapes in ``spell_bwd_plain``).  dlogits [L, B, V] and daext [L, B, S]
    are the cotangents of the logits and attention maps; ``streams`` are
    ``spell_fwd``'s (a, h1s, c1s, h2s, c2s, fed); W the speller weights in
    ``x @ W`` layout (``decode.speller_weights``); ``gates`` the forward's
    (g1s, g2s) from ``spell_fwd(..., with_gates=True)``: the cluster route
    on the card reads them and raises without them, the one-row kernel
    recomputes them.  ``route`` overrides ``spell_route`` on the card
    (tests)."""
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
    if gates is not None and any(g is None or g.shape != (L, B, 4 * H) for g in gates):
        raise ValueError(f"spell_bwd: gates must be two [L, B, 4H] = [{L}, {B}, {4 * H}] tensors")
    if enc_h.device.type == "cpu":
        return spell_bwd_plain(enc_h, comp_h, dlogits, daext, streams, W, gates)
    dev = enc_h.device
    if dev.type != "cuda":
        raise ValueError(f"spell_bwd: no kernel for device {dev}")
    R = spell_route(B, H, F, M, S, V) if route is None else route
    if R and gates is None:
        raise ValueError("spell_bwd: the cluster route reads the forward's gates; pass "
                         "gates=spell_fwd(..., with_gates=True)[7:]")
    ins = [kernel_operand(t.detach(), dev)
           for t in (enc_h, comp_h, dlogits, daext, *streams, *W[:8], W[9])]
    if R:
        ins += [kernel_operand(g.detach(), dev) for g in gates]
        scratch = [torch.empty(4 * H, n, dtype=torch.float32, device=dev)
                   for n in (2 * H + F, 2 * H)]
    else:
        ins += [None, None]
        scratch = [None, None]
    outs = [torch.empty(L, B, n, dtype=torch.float32, device=dev)
            for n in (4 * H, 4 * H, S, M, H)]
    if B == 0 or L == 0:
        return tuple(outs)
    lib = build.load_library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.ss_spell_bwd(
        *[ptr(t) for t in ins], *[ptr(t) for t in scratch], *[o.data_ptr() for o in outs],
        B, S, F, M, H, V, L, R, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "ss_spell_bwd")
    build.count_launch(LAUNCHES, "spell_bwd")
    if R:
        build.count_launch(LAUNCHES, "spell_bwd_cluster")
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
        # the gates only where a backward will read them
        grad = any(ctx.needs_input_grad)
        out = spell_fwd(model, enc_h, comp_h, enc_lens, tf_draws, gumbel, teacher_emb,
                        with_gates=grad)
        streams, gates = out[:7], out[7:]
        ctx.has_gates = grad and gates[0] is not None
        ctx.save_for_backward(enc_h, comp_h, tf_draws, gumbel, *streams, *W,
                              *(gates if ctx.has_gates else ()))
        return streams[0], streams[1]

    @staticmethod
    def backward(ctx, dlogits, da_ext):
        enc_h, comp_h, tf_draws, gumbel, logits, *rest = ctx.saved_tensors
        streams, W = tuple(rest[:6]), rest[6:16]
        gates = tuple(rest[16:]) if ctx.has_gates else None
        phi, wih1, whh1, b1, wih2, whh2, b2, ct_w, ct_b, emb = W
        a, h1s = streams[0], streams[1]
        if da_ext is None:  # a loss that reads no attention map
            da_ext = torch.zeros_like(a)
        dlogits = torch.zeros_like(logits) if dlogits is None else dlogits.contiguous()
        dg1, dg2, de, dqp, demb = spell_bwd(enc_h, comp_h, dlogits, da_ext, streams, W, gates)
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
