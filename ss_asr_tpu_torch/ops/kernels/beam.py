"""Whole-loop beam-search frontier (± char-LM fusion): CUDA kernel wrapper
and its plain version.

Kernels: ``csrc/beam_decode.cu`` — ``ss_beam_decode`` and
``ss_beam_decode_lm`` replace the TPU kernel
``ss_asr_tpu/ops/pallas/beam.py::_make_kernel(K, use_lm)``.  The source's
header says what bounds them on an H100 and how the design answers it.

``beam_device`` routes by device: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs ``beam_scan_plain``, the port of the early-exit
scan ``ss_asr_tpu/decode/beam.py::_beam_scan`` (with its terminal EOS
charge), which the kernels are held against.  Both return the frontier
trace ``(toks [T, B, K], parents [T, B, K], scores [B, K], done [B, K],
hyp_len [B, K])``; the backtrack runs on the host (``decode/beam.py``).

Semantics, as in JAX: only beam 0 is live at the start (the others score
``NEG_INF``); a finished beam may only extend by SOS at no cost; the K best
of the ``K * V`` candidates survive, ties to the lower flat index (lower
beam, then lower token: ``lax.top_k``'s rule); ``hyp_len`` counts the
characters before EOS; beams still open after the last step pay the cost
of emitting EOS.  ``NEG_INF = -1e30`` masks candidates, while attention
masks with ``-inf``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ss_asr_tpu_torch.models import charlm as charlm_mod
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops import rnn
from ss_asr_tpu_torch.ops.kernels import build
from ss_asr_tpu_torch.ops.kernels.decode import kernel_operand, lm_operands, speller_operands
from ss_asr_tpu_torch.vocab import EOS_ID, SOS_ID

#: kernel launches made by ``beam_device`` on CUDA tensors
LAUNCHES = {"beam_decode": 0, "beam_decode_lm": 0}

#: candidate mask of the JAX beam search
NEG_INF = -1e30

#: the widest frontier the kernel takes (the server's n-best cap)
MAX_BEAM = 16

Frontier = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def beam_scan_plain(
    model: las.LAS, enc_h: torch.Tensor, comp_h: torch.Tensor, enc_lens: torch.Tensor,
    K: int, max_steps: int, lm: Optional[charlm_mod.CharLM] = None, lm_weight: float = 0.0,
) -> Frontier:
    """The beam frontier in plain PyTorch, stopping once every beam is done.

    ``lm`` given means LM fusion."""
    B, S, _ = enc_h.shape
    dev = enc_h.device
    V = model.cfg.vocab_size
    valid = las.attention_mask(enc_lens.to(dev), S)
    encK = enc_h.repeat_interleave(K, 0)
    compK = comp_h.repeat_interleave(K, 0)
    validK = valid.repeat_interleave(K, 0)

    def forward(state, lm_state, last):
        """Every beam's step: (new state, new LM state, log-probs [B, K, V])."""
        _, context = las.attention_step(model.attention, compK, encK, state[0][0], validK)
        dec_in = torch.cat([rnn.embed(model.embed, last), context], dim=-1)
        state, dec_out = las.speller_step(model.decoder, dec_in, state)
        logp = torch.log_softmax(rnn.linear(model.char_trans, dec_out), dim=-1)
        if lm is not None:
            lm_logits, lm_state = charlm_mod.step(lm, last, lm_state)
            logp = logp + lm_weight * torch.log_softmax(lm_logits, dim=-1)
        return state, lm_state, logp.view(B, K, V)

    state = las.speller_init_state(B * K, model.cfg, dev)
    lm_state = charlm_mod.init_state(B * K, lm.cfg, dev) if lm is not None else None
    last = torch.full((B * K,), SOS_ID, dtype=torch.long, device=dev)
    scores = torch.full((B, K), NEG_INF, device=dev)
    scores[:, 0] = 0.0  # only beam 0 is live at the start
    done = torch.zeros(B, K, dtype=torch.bool, device=dev)
    hyp_len = torch.zeros(B, K, dtype=torch.int32, device=dev)
    # unwritten steps keep SOS tokens and identity parents
    toks = torch.full((max_steps, B, K), SOS_ID, dtype=torch.int32, device=dev)
    parents = torch.arange(K, dtype=torch.int32, device=dev).expand(max_steps, B, K).clone()
    pad_row = torch.full((V,), NEG_INF, device=dev)
    pad_row[SOS_ID] = 0.0
    rows = torch.arange(B, device=dev)[:, None] * K

    for t in range(max_steps):
        if bool(done.all()):
            break
        state, lm_state, logp = forward(state, lm_state, last)
        # a finished beam may only extend by SOS, at no cost
        logp = torch.where(done[:, :, None], pad_row, logp)
        cand = (scores[:, :, None] + logp).reshape(B, K * V)
        # a stable sort keeps equal candidates in flat-index order
        top_i = torch.sort(-cand, dim=1, stable=True).indices[:, :K]
        parent = top_i // V
        token = top_i % V
        flat = (rows + parent).reshape(-1)
        state = tuple(tuple(s[flat] for s in layer) for layer in state)
        if lm is not None:
            lm_state = tuple(s[flat] for s in lm_state)
        parent_done = torch.gather(done, 1, parent)
        ended = parent_done | (token == EOS_ID)
        hyp_len = torch.gather(hyp_len, 1, parent) + (~ended).to(torch.int32)
        done = ended
        scores = torch.gather(cand, 1, top_i)
        last = token.reshape(-1)
        toks[t] = token.to(torch.int32)
        parents[t] = parent.to(torch.int32)

    # the still-open beams pay the cost of emitting EOS from their last state
    _, _, logp = forward(state, lm_state, last)
    scores = torch.where(done, scores, scores + logp[:, :, EOS_ID])
    return toks, parents, scores, done, hyp_len


def beam_device(
    model: las.LAS, enc_h: torch.Tensor, comp_h: torch.Tensor, enc_lens: torch.Tensor,
    K: int, max_steps: int, lm: Optional[charlm_mod.CharLM] = None, lm_weight: float = 0.0,
) -> Frontier:
    """The beam frontier from listener memory.

    enc_h [B, S, F] and comp_h [B, S, M] float32; enc_lens [B] listener
    lengths (clamped to >= 1 here); ``lm`` given means LM fusion; K in
    1..``MAX_BEAM``."""
    if not 1 <= K <= MAX_BEAM:
        raise ValueError(f"beam_device: beam size {K} outside 1..{MAX_BEAM}")
    if enc_h.device.type == "cpu":
        return beam_scan_plain(model, enc_h, comp_h, enc_lens, K, max_steps, lm, lm_weight)
    dev = enc_h.device
    if dev.type != "cuda":
        raise ValueError(f"beam_device: no kernel for device {dev}")
    B, S, F = enc_h.shape
    cfg = model.cfg
    H, M, V = cfg.decoder_state_size, cfg.mlp_out_size, cfg.vocab_size
    if F != cfg.enc_out_dim or comp_h.shape != (B, S, M) or enc_lens.shape != (B,) or S < 1:
        raise ValueError(
            f"beam_device: enc_h {tuple(enc_h.shape)}, comp_h {tuple(comp_h.shape)}, "
            f"enc_lens {tuple(enc_lens.shape)} do not fit {cfg}")
    enc_h = kernel_operand(enc_h, dev)
    comp_h = kernel_operand(comp_h, dev)
    lens = torch.clamp(enc_lens.to(device=dev, dtype=torch.int32), min=1).contiguous()
    toks = torch.empty(max_steps, B, K, dtype=torch.int32, device=dev)
    parents = torch.empty_like(toks)
    scores = torch.empty(B, K, dtype=torch.float32, device=dev)
    done = torch.empty(B, K, dtype=torch.int32, device=dev)
    hyp_len = torch.empty(B, K, dtype=torch.int32, device=dev)
    # attention scratch for an S whose weights outgrow the shared buffer
    att = torch.empty(B, S, MAX_BEAM, dtype=torch.float32, device=dev)
    if B == 0:
        return toks, parents, scores, done.bool(), hyp_len
    lib = build.load_library()
    spell = speller_operands(model, dev)
    args = ([enc_h.data_ptr(), comp_h.data_ptr(), lens.data_ptr()]
            + [w.data_ptr() for w in spell]
            + [t.data_ptr() for t in (toks, parents, scores, done, hyp_len, att)]
            + [B, S, F, M, H, V, K, max_steps])
    stream = torch.cuda.current_stream(dev).cuda_stream
    if lm is None:
        err = lib.ss_beam_decode(*args, dev.index or 0, stream)
        build.check(err, "ss_beam_decode")
        build.count_launch(LAUNCHES, "beam_decode")
    else:
        lmw = lm_operands(lm, dev)
        err = lib.ss_beam_decode_lm(
            *args, *[w.data_ptr() for w in lmw], lm.cfg.hidden_size, float(lm_weight),
            dev.index or 0, stream)
        build.check(err, "ss_beam_decode_lm")
        build.count_launch(LAUNCHES, "beam_decode_lm")
    return toks, parents, scores, done.bool(), hyp_len
