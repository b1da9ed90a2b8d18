"""Whole-loop greedy decode (± char-LM fusion): CUDA kernel wrapper and
its plain version.

Kernels: ``csrc/greedy_decode.cu`` — ``ss_greedy_decode`` replaces the TPU
kernel ``ss_asr_tpu/ops/pallas/decode.py::_decode_kernel`` and
``ss_greedy_decode_lm`` replaces ``::_decode_lm_kernel``.  The source's
header says what bounds them on an H100 and how the design answers it.

``greedy_decode`` routes by device: a CUDA tensor launches a kernel (or
raises), a CPU tensor runs ``greedy_decode_plain``, the early-exit greedy
loop of ``ss_asr_tpu/decode/greedy.py`` written with this package's model
functions, which the kernels are held against.  Both return the raw
``[B, max_steps]`` int32 tokens (SOS after a row's EOS); ``_finalize``
(decode/greedy.py) runs after either, outside the kernel, as in JAX.

Scoring follows the TPU kernels: without the LM the argmax is over the raw
logits (the JAX scan's ``log_softmax`` shifts every logit by one constant,
which leaves the argmax unchanged); with it, over
``log_softmax(asr) + lm_weight * log_softmax(lm)``.  Ties go to the lowest
index, as ``jnp.argmax``.

On the card the kernels have two routes, which ``greedy_route`` picks from
the shape alone: the cluster route (a thread-block cluster of H / 32 CTAs
per tile of R batch rows, each CTA streaming its 128 gate columns of the
cell weights, and with the LM its columns of the GRUs, once a step for all
R rows; ``LAUNCHES["greedy_decode_cluster"]`` / ``["greedy_decode_lm_cluster"]``
count it) and, for shapes it does not serve, the one-row kernel (a block
per batch row).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ss_asr_tpu_torch.models import charlm as charlm_mod
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops import rnn
from ss_asr_tpu_torch.ops.kernels import build
from ss_asr_tpu_torch.ops.kernels.lstm import SMEM_BYTES
from ss_asr_tpu_torch.ops.kernels.speller_cluster import (SP_COLS, SP_THREADS, SP_UNITS, SP_WARPS,
                                                          cluster_shape_serves, r4, tile_route)
from ss_asr_tpu_torch.vocab import EOS_ID, SOS_ID

#: kernel launches made by ``greedy_decode`` on CUDA tensors; the
#: ``_cluster`` counters count those that took the cluster route
LAUNCHES = {"greedy_decode": 0, "greedy_decode_cluster": 0, "greedy_decode_lm": 0,
            "greedy_decode_lm_cluster": 0}

#: the tile heights (batch rows a cluster) the cluster route is written for
GREEDY_TILE_ROWS = (1, 2, 4)


def greedy_decode_plain(
    model: las.LAS, enc_h: torch.Tensor, comp_h: torch.Tensor, enc_lens: torch.Tensor,
    max_steps: int, lm: Optional[charlm_mod.CharLM] = None, lm_weight: float = 0.0,
) -> torch.Tensor:
    """Batched greedy decode in plain PyTorch; stops once every row is done."""
    B, S, _ = enc_h.shape
    dev = enc_h.device
    valid = las.attention_mask(enc_lens.to(dev), S)
    state = las.speller_init_state(B, model.cfg, dev)
    lm_state = charlm_mod.init_state(B, lm.cfg, dev) if lm is not None else None
    last = torch.full((B,), SOS_ID, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    toks = torch.full((B, max_steps), SOS_ID, dtype=torch.int32, device=dev)
    for t in range(max_steps):
        if bool(done.all()):
            break
        _, context = las.attention_step(model.attention, comp_h, enc_h, state[0][0], valid)
        dec_in = torch.cat([rnn.embed(model.embed, last), context], dim=-1)
        state, dec_out = las.speller_step(model.decoder, dec_in, state)
        score = rnn.linear(model.char_trans, dec_out)
        if lm is not None:
            lm_logits, lm_state = charlm_mod.step(lm, last, lm_state)
            score = (torch.log_softmax(score, dim=-1)
                     + lm_weight * torch.log_softmax(lm_logits, dim=-1))
        ids = torch.argmax(score, dim=-1)
        toks[:, t] = torch.where(done, torch.full_like(ids, SOS_ID), ids).to(torch.int32)
        done = done | (ids == EOS_ID)
        last = ids
    return toks


def greedy_smem_bytes(H: int, F: int, M: int, S: int, V: int, HL: int, R: int) -> int:
    """Shared memory of one CTA of K6 / K7's cluster route (``greedy_plan``
    in ``csrc/greedy_decode.cu``), HL = 0 without the LM: h1 and h2
    double-buffered, the fed embedding, the gathered context, query and
    energies, the own cell carries, the warps' gate partials, the small
    products' partials, the own columns' gates, the logits, the resident
    ct_w, ct_b, phi's own columns and the own columns' biases, four [R]
    index arrays; with the LM its input embedding, both GRU states
    double-buffered, the own GRU columns' sums, the LM's logits, the
    resident out_w and out_b, and both GRUs' biases at the own columns."""
    Mc = M // (H // 32)
    lm = HL > 0
    floats = (2 * r4(2 * R * H) + r4(R * H) + r4(R * F) + r4(R * M) + r4(R * S)
              + 2 * r4(R * SP_UNITS) + r4(SP_WARPS * R * SP_COLS)
              + r4(SP_THREADS * max(R, 4)) + R * SP_COLS + r4(R * V) + r4(H * V) + r4(V)
              + r4(H * Mc) + 2 * SP_COLS + 4 * r4(R)
              + r4(R * HL) + 2 * r4(2 * R * HL) + r4(HL * V)
              + lm * (R * SP_COLS + r4(R * V) + r4(V) + 2 * SP_COLS))
    return 4 * floats


def greedy_cluster_serves(H: int, F: int, M: int, S: int, V: int, HL: int, R: int) -> bool:
    """Whether the cluster route serves this shape with tiles of R rows:
    ``speller_cluster.cluster_shape_serves``; with the LM (HL > 0), HL / C
    units a CTA in float4s whose six gate blocks (r, z, n of W_ih and W_hh)
    fit its 128 partial columns; the buffers inside one block's shared
    memory."""
    C = H // 32
    return (R in GREEDY_TILE_ROWS and cluster_shape_serves(H, F, M, S, V)
            and (HL == 0 or (HL % (4 * C) == 0 and 6 * (HL // C) <= SP_COLS))
            and greedy_smem_bytes(H, F, M, S, V, HL, R) <= SMEM_BYTES)


def greedy_route(B: int, H: int, F: int, M: int, S: int, V: int, HL: int) -> int:
    """The route of ``greedy_decode`` on the card, from the shape alone
    (HL = 0 without the LM) -> R: the cluster route with tiles of R batch
    rows, R the smallest of 1, 2, 4 that serves and whose clusters of
    H / 32 CTAs are all resident at once (15 of 8 CTAs: B <= 15 takes tiles
    of 1 row, B = 16 of 2, B = 32 of 4), else the largest that serves (B = 64
    runs 16 tiles of 4 in two waves); or 0, the one-row kernel, where none
    serves (H not a multiple of 32 or above 256, an LM whose units do not
    split into float4s, or buffers past shared memory)."""
    return tile_route(B, H, [R for R in GREEDY_TILE_ROWS
                             if greedy_cluster_serves(H, F, M, S, V, HL, R)])


def kernel_operand(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` as a contiguous float32 kernel operand on ``device``, or raise."""
    if t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"kernel operand: expected float32 on {device}, got {t.dtype} on {t.device}")
    return t.contiguous()


def speller_weights(model: las.LAS) -> List[torch.Tensor]:
    """The speller's weights in ``x @ W`` layout, as autograd views of the
    module parameters: phi [H, M], W_ih1 [H+F, 4H], W_hh1, b1, W_ih2, W_hh2,
    b2, ct_w [H, V], ct_b, emb [V, H] (the JAX package's tree order)."""
    d = model.decoder
    return [
        model.attention.phi.weight.t(),
        d.layer_1.weight_ih.t(), d.layer_1.weight_hh.t(), d.layer_1.bias_ih + d.layer_1.bias_hh,
        d.layer_2.weight_ih.t(), d.layer_2.weight_hh.t(), d.layer_2.bias_ih + d.layer_2.bias_hh,
        model.char_trans.weight.t(), model.char_trans.bias, model.embed.weight,
    ]


def speller_operands(model: las.LAS, device: torch.device) -> List[torch.Tensor]:
    """``speller_weights`` as the decode kernels' contiguous operands."""
    return [kernel_operand(w.detach(), device) for w in speller_weights(model)]


def lm_operands(lm: charlm_mod.CharLM, device: torch.device) -> List[torch.Tensor]:
    """The LM weights in ``x @ W`` layout: emb [V, HL], then per GRU
    W_ih [HL, 3HL], W_hh, b_ih, b_hh, then out_w [HL, V], out_b."""
    ws = [lm.emb.weight]
    for g in (lm.layer_1, lm.layer_2):
        ws += [g.weight_ih.t(), g.weight_hh.t(), g.bias_ih, g.bias_hh]
    ws += [lm.out.weight.t(), lm.out.bias]
    return [kernel_operand(w.detach(), device) for w in ws]


def greedy_decode(
    model: las.LAS, enc_h: torch.Tensor, comp_h: torch.Tensor, enc_lens: torch.Tensor,
    max_steps: int, lm: Optional[charlm_mod.CharLM] = None, lm_weight: float = 0.0,
    route: Optional[int] = None,
) -> torch.Tensor:
    """Greedy decode from listener memory -> raw tokens [B, max_steps] int32.

    enc_h [B, S, F] and comp_h [B, S, M] float32; enc_lens [B] listener
    lengths (clamped to >= 1 inside); ``lm`` given means LM fusion.
    ``route`` overrides ``greedy_route`` on the card (tests)."""
    if enc_h.device.type == "cpu":
        return greedy_decode_plain(model, enc_h, comp_h, enc_lens, max_steps, lm, lm_weight)
    dev = enc_h.device
    if dev.type != "cuda":
        raise ValueError(f"greedy_decode: no kernel for device {dev}")
    B, S, F = enc_h.shape
    cfg = model.cfg
    H, M, V = cfg.decoder_state_size, cfg.mlp_out_size, cfg.vocab_size
    if F != cfg.enc_out_dim or comp_h.shape != (B, S, M) or enc_lens.shape != (B,) or S < 1:
        raise ValueError(
            f"greedy_decode: enc_h {tuple(enc_h.shape)}, comp_h {tuple(comp_h.shape)}, "
            f"enc_lens {tuple(enc_lens.shape)} do not fit {cfg}")
    enc_h = kernel_operand(enc_h, dev)
    comp_h = kernel_operand(comp_h, dev)
    lens = enc_lens.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty(B, max_steps, dtype=torch.int32, device=dev)
    if B == 0 or max_steps == 0:
        return out
    HL = lm.cfg.hidden_size if lm is not None else 0
    R = greedy_route(B, H, F, M, S, V, HL) if route is None else route
    lib = build.load_library()
    spell = speller_operands(model, dev)
    args = ([enc_h.data_ptr(), comp_h.data_ptr(), lens.data_ptr()]
            + [w.data_ptr() for w in spell] + [out.data_ptr(), B, S, F, M, H, V, max_steps])
    stream = torch.cuda.current_stream(dev).cuda_stream
    if lm is None:
        name = "greedy_decode"
        err = lib.ss_greedy_decode(*args, R, dev.index or 0, stream)
    else:
        name = "greedy_decode_lm"
        lmw = lm_operands(lm, dev)
        err = lib.ss_greedy_decode_lm(*args, *[w.data_ptr() for w in lmw], HL, float(lm_weight),
                                      R, dev.index or 0, stream)
    build.check(err, f"ss_{name}")
    build.count_launch(LAUNCHES, name)
    if R:
        build.count_launch(LAUNCHES, f"{name}_cluster")
    return out
