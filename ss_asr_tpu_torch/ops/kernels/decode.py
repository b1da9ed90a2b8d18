"""Whole-loop greedy decode (± char-LM fusion): CUDA kernel wrapper and
its plain version.

Kernels: ``csrc/greedy_decode.cu`` — ``ss_greedy_decode`` replaces the TPU
kernel ``ss_asr_tpu/ops/pallas/decode.py::_decode_kernel`` and
``ss_greedy_decode_lm`` replaces ``::_decode_lm_kernel``.  The source's
header says what bounds them on an H100 and how the design answers it.

``greedy_decode`` routes by device: a CUDA tensor launches the kernel (or
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
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ss_asr_tpu_torch.models import charlm as charlm_mod
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops import rnn
from ss_asr_tpu_torch.ops.kernels import build
from ss_asr_tpu_torch.vocab import EOS_ID, SOS_ID

#: kernel launches made by ``greedy_decode`` on CUDA tensors
LAUNCHES = {"greedy_decode": 0, "greedy_decode_lm": 0}


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


def _kernel_operand(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"greedy_decode: expected float32 on {device}, got {t.dtype} on {t.device}")
    return t.contiguous()


def speller_operands(model: las.LAS, device: torch.device) -> List[torch.Tensor]:
    """The decode kernel's weights in ``x @ W`` layout:
    phi [H, M], W_ih1 [H+F, 4H], W_hh1, b1, W_ih2, W_hh2, b2, ct_w [H, V],
    ct_b, emb [V, H]."""
    d = model.decoder
    ws = [
        model.attention.phi.weight.t(),
        d.layer_1.weight_ih.t(), d.layer_1.weight_hh.t(), d.layer_1.bias_ih + d.layer_1.bias_hh,
        d.layer_2.weight_ih.t(), d.layer_2.weight_hh.t(), d.layer_2.bias_ih + d.layer_2.bias_hh,
        model.char_trans.weight.t(), model.char_trans.bias, model.embed.weight,
    ]
    return [_kernel_operand(w.detach(), device) for w in ws]


def lm_operands(lm: charlm_mod.CharLM, device: torch.device) -> List[torch.Tensor]:
    """The LM weights in ``x @ W`` layout: emb [V, HL], then per GRU
    W_ih [HL, 3HL], W_hh, b_ih, b_hh, then out_w [HL, V], out_b."""
    ws = [lm.emb.weight]
    for g in (lm.layer_1, lm.layer_2):
        ws += [g.weight_ih.t(), g.weight_hh.t(), g.bias_ih, g.bias_hh]
    ws += [lm.out.weight.t(), lm.out.bias]
    return [_kernel_operand(w.detach(), device) for w in ws]


def greedy_decode(
    model: las.LAS, enc_h: torch.Tensor, comp_h: torch.Tensor, enc_lens: torch.Tensor,
    max_steps: int, lm: Optional[charlm_mod.CharLM] = None, lm_weight: float = 0.0,
) -> torch.Tensor:
    """Greedy decode from listener memory -> raw tokens [B, max_steps] int32.

    enc_h [B, S, F] and comp_h [B, S, M] float32; enc_lens [B] listener
    lengths (clamped to >= 1 inside); ``lm`` given means LM fusion."""
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
    enc_h = _kernel_operand(enc_h, dev)
    comp_h = _kernel_operand(comp_h, dev)
    lens = enc_lens.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty(B, max_steps, dtype=torch.int32, device=dev)
    if B == 0 or max_steps == 0:
        return out
    lib = build.load_library()
    spell = speller_operands(model, dev)
    args = ([enc_h.data_ptr(), comp_h.data_ptr(), lens.data_ptr()]
            + [w.data_ptr() for w in spell] + [out.data_ptr(), B, S, F, M, H, V, max_steps])
    stream = torch.cuda.current_stream(dev).cuda_stream
    if lm is None:
        err = lib.ss_greedy_decode(*args, dev.index or 0, stream)
        build.check(err, "ss_greedy_decode")
        LAUNCHES["greedy_decode"] += 1
    else:
        lmw = lm_operands(lm, dev)
        err = lib.ss_greedy_decode_lm(
            *args, *[w.data_ptr() for w in lmw], lm.cfg.hidden_size, float(lm_weight),
            dev.index or 0, stream)
        build.check(err, "ss_greedy_decode_lm")
        LAUNCHES["greedy_decode_lm"] += 1
    return out
