"""Whole-loop beam-search frontier (± char-LM fusion): CUDA kernel wrapper
and its plain version.

Kernels: ``csrc/beam_decode.cu`` — ``ss_beam_decode_cluster`` (the cluster
route), ``ss_beam_decode`` and ``ss_beam_decode_lm`` (one block per
utterance, for shapes no cluster serves) replace the TPU kernel
``ss_asr_tpu/ops/pallas/beam.py::_make_kernel(K, use_lm)``.  The source's
header says what bounds them on an H100 and how the design answers it;
``beam_route`` picks the route from the shape alone.

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

import weakref
from typing import List, Optional, Tuple

import torch

from ss_asr_tpu_torch.models import charlm as charlm_mod
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops import rnn
from ss_asr_tpu_torch.ops.kernels import build
from ss_asr_tpu_torch.ops.kernels.decode import kernel_operand, lm_operands, speller_operands
from ss_asr_tpu_torch.vocab import EOS_ID, SOS_ID

#: kernel launches made by ``beam_device`` on CUDA tensors (``beam_decode`` or
#: ``beam_decode_lm`` by the LM); ``beam_decode_cluster`` /
#: ``beam_decode_lm_cluster`` count those that took the cluster route
LAUNCHES = {"beam_decode": 0, "beam_decode_lm": 0, "beam_decode_cluster": 0,
            "beam_decode_lm_cluster": 0}

#: what the cluster route of ``csrc/beam_decode.cu`` is sized by (its
#: ``cluster_plan``): the gate columns a CTA owns (its weight stream's
#: width, 4H / C); the stream rows of one ring stage (at a pitch of the
#: width + 16 floats); the ring's largest depth; the most rows (utterances x
#: beams, each K padded to 4, 8 or 16) a cluster decodes: one utterance's
#: 16, or half that for two; and the shared memory of an H100 block (floats)
STREAM_WIDTH = 128
STAGE_ROWS = 32
MAX_STAGES = 8
CLUSTER_ROWS = 16
SMEM_FLOATS = 227 * 1024 // 4
#: the clusters of each size that an H100 SXM holds at once (one CTA an SM)
CARD_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}

#: candidate mask of the JAX beam search
NEG_INF = -1e30

#: the widest frontier the kernel takes (the server's n-best cap)
MAX_BEAM = 16

Frontier = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def beam_scan_plain(
    model: las.LAS, enc_h: torch.Tensor, comp_h: torch.Tensor, enc_lens: torch.Tensor,
    K: int, max_steps: int, lm: Optional[charlm_mod.CharLM] = None, lm_weight: float = 0.0,
    early_exit: bool = True,
) -> Frontier:
    """The beam frontier in plain PyTorch, stopping once every beam is done
    (``early_exit``) or after all ``max_steps`` (the fixed-trip scan).

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
        if early_exit and bool(done.all()):
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


def _up4(n: int) -> int:
    return (n + 3) & ~3


def beam_rows(K: int) -> int:
    """The rows a cluster gives each utterance's K beams: K rounded up to
    4, 8 or 16."""
    return 4 if K <= 4 else 8 if K <= 8 else 16


def cluster_plan(H: int, F: int, M: int, V: int, HL: int, S: int, K: int, C: int,
                 U: int) -> Optional[Tuple[int, bool, int]]:
    """The shared memory of a CTA of the cluster route (``cluster_plan`` in
    ``csrc/beam_decode.cu``, which ``ss_beam_cluster_plan`` reports) ->
    ``(floats, attention in shared memory, ring stages)``, or None where the
    route does not serve the shape: C CTAs own ``STREAM_WIDTH`` = 4H / C
    gate columns each (so H = 32 C, C <= 8); K <= min(16, V); rows U x
    ``beam_rows(K)`` at most 8, or 16 for one utterance; F and the LM's HL
    in whole ring stages; the LM's 6 HL / C columns inside the stream's
    width; a ring of at least 3 stages.

    At 4 and 8 rows h1, h2 and the GRU states are double-buffered by step
    parity.  The 16-row variant keeps one copy of each and the context in
    the context partials' buffer, its writes held back by split cluster
    barriers (its F / C context features staged in the stream's width):
    at the flagship width (H 256, F 512, M 128, V 50, HL 128, C 8) 40,352
    floats with the LM and 33,312 without, where double buffers would take
    68,032 and 56,896 of a block's 58,112 and leave no room for the ring.
    In every variant the logit partials share the context partials' buffer
    and the candidates the queries'."""
    SW = STREAM_WIDTH
    NR = U * beam_rows(K)
    single = NR > CLUSTER_ROWS // 2
    if not (C in CARD_CLUSTERS and U >= 1 and 1 <= K <= min(CLUSTER_ROWS, V)
            and NR <= (CLUSTER_ROWS if U == 1 else CLUSTER_ROWS // 2)
            and 4 * H == SW * C and F % STAGE_ROWS == 0 and F % (4 * C) == 0
            and (not single or F // C <= SW) and M % C == 0 and M % 4 == 0
            and (HL == 0 or (HL % STAGE_ROWS == 0 and HL % C == 0
                             and 6 * (HL // C) <= SW and (3 * HL // C) % 4 == 0))):
        return None
    Hc, Fc, Mc, Vc, Sc = H // C, F // C, M // C, -(-V // C), -(-S // C)
    nb = 1 if single else 2  # copies of h1, h2 and the GRU states
    sizes = [H * NR, 0 if single else F * NR, nb * H * NR, nb * H * NR, HL * NR,
             nb * HL * NR, nb * HL * NR, Hc * NR, Hc * NR, max(M, V) * NR, H * Mc, Hc * V,
             HL * Vc, SW * NR, max(F, C * V) * NR, 2 * C * NR, V * NR, V * NR,
             8 * CLUSTER_ROWS + 32]
    fixed = sum(_up4(n) for n in sizes)
    stage = STAGE_ROWS * (SW + 16)
    att_smem = fixed + _up4(Sc * NR) + 3 * stage <= SMEM_FLOATS
    if att_smem:
        fixed += _up4(Sc * NR)
    nst = min(MAX_STAGES, (SMEM_FLOATS - fixed) // stage)
    if nst < 3:
        return None
    return fixed + nst * stage, att_smem, nst


def device_cluster_plan(H: int, F: int, M: int, V: int, HL: int, S: int, K: int, C: int,
                        U: int, device: torch.device) -> Optional[Tuple[int, bool, int]]:
    """``cluster_plan`` as ``csrc/beam_decode.cu`` computes it for the card
    (``ss_beam_cluster_plan``, from the card's shared memory a block), in
    the same form: what the Python mirror is held to."""
    import ctypes

    out = (ctypes.c_int * 3)()
    lib = build.load_library()
    err = lib.ss_beam_cluster_plan(H, F, M, V, HL, S, K, C, U, torch.device(device).index or 0,
                                   ctypes.addressof(out))
    build.check(err, "ss_beam_cluster_plan")
    return (out[0], bool(out[1]), out[2]) if out[0] else None


def beam_route(H: int, F: int, M: int, V: int, HL: int, S: int, K: int, B: int
               ) -> Tuple[int, int]:
    """The route of ``beam_device`` on the card, from the shape alone ->
    ``(C, U)``: a cluster of C = 4H / ``STREAM_WIDTH`` CTAs over U
    utterances; or ``(0, 0)``, the kernel of one block per utterance, where
    ``cluster_plan`` serves no U (H other than 32, 64, 128 or 256, F or HL
    not in whole ring stages, a wide LM, V below K, a plan past shared
    memory).  U is the smallest that keeps every cluster resident at once,
    else the largest that serves: K 5-16 take one utterance a cluster, and
    at K 9-16 a batch past 15 (the clusters of 8 an H100 holds) runs in
    waves."""
    C = 4 * H // STREAM_WIDTH if 4 * H % STREAM_WIDTH == 0 else 0
    fits = [U for U in (1, 2) if cluster_plan(H, F, M, V, HL, S, K, C, U) is not None]
    if not fits:
        return 0, 0
    resident = [U for U in fits if -(-B // U) <= CARD_CLUSTERS[C]]
    return C, (resident[0] if resident else fits[-1])


def weight_stream(ws: List[torch.Tensor], lm_ws: Optional[List[torch.Tensor]],
                  C: int) -> torch.Tensor:
    """Each CTA's weight panels for the cluster route, in the order a step
    reads them -> [C, rows, 4H / C]: the LM's two GRU cells ([HL] rows of the
    input-side r, z, n columns of its HL / C units, then the hidden-side
    ones, zero-padded to the width) and the speller's two cells ([W_ih1;
    W_hh1] and [W_ih2; W_hh2], the i, f, g, o columns of its H / C units)."""
    _, wih1, whh1, _, wih2, whh2 = ws[:6]
    H = whh1.shape[0]
    dev = whh1.device
    j = torch.arange(H // C, device=dev)
    cols = (torch.arange(4, device=dev)[None, :, None] * H
            + torch.arange(C, device=dev)[:, None, None] * (H // C) + j).reshape(C, -1)
    panels = []
    if lm_ws is not None:
        HL = lm_ws[2].shape[0]
        jl = torch.arange(HL // C, device=dev)
        lcols = (torch.arange(3, device=dev)[None, :, None] * HL
                 + torch.arange(C, device=dev)[:, None, None] * (HL // C) + jl).reshape(C, -1)
        for wih, whh in ((lm_ws[1], lm_ws[2]), (lm_ws[5], lm_ws[6])):
            g = torch.cat([wih[:, lcols], whh[:, lcols]], dim=2)  # [HL, C, 6 HL / C]
            panels.append(torch.nn.functional.pad(g, (0, 4 * H // C - g.shape[2])))
    for a, b in ((wih1, whh1), (wih2, whh2)):
        panels.append(torch.cat([a, b])[:, cols])  # [rows, C, 4H / C]
    return torch.cat(panels).transpose(0, 1).contiguous()


#: each model's packed weight streams, by (LM, cluster size, device), with
#: the version counters of the weights they were packed from
_STREAMS: "weakref.WeakKeyDictionary[las.LAS, dict]" = weakref.WeakKeyDictionary()


def cached_weight_stream(model: las.LAS, lm: Optional[charlm_mod.CharLM],
                         ws: List[torch.Tensor], lm_ws: Optional[List[torch.Tensor]],
                         C: int) -> torch.Tensor:
    """``weight_stream(ws, lm_ws, C)``, packed once per (model, LM, C,
    device) and again only after a weight changed in place (an optimizer
    step, ``load_state_dict``); a hot reload builds new modules, whose
    streams are packed on their first decode."""
    params = list(model.parameters()) + (list(lm.parameters()) if lm is not None else [])
    versions = tuple(p._version for p in params)
    key = (id(lm), C, ws[0].device)
    per_model = _STREAMS.setdefault(model, {})
    hit = per_model.get(key)
    if hit is not None and hit[0] is lm and hit[1] == versions:
        return hit[2]
    stream = weight_stream(ws, lm_ws, C)
    per_model[key] = (lm, versions, stream)
    return stream


def beam_device(
    model: las.LAS, enc_h: torch.Tensor, comp_h: torch.Tensor, enc_lens: torch.Tensor,
    K: int, max_steps: int, lm: Optional[charlm_mod.CharLM] = None, lm_weight: float = 0.0,
    route: Optional[Tuple[int, int]] = None, early_exit: bool = True,
) -> Frontier:
    """The beam frontier from listener memory.

    enc_h [B, S, F] and comp_h [B, S, M] float32; enc_lens [B] listener
    lengths (clamped to >= 1 here); ``lm`` given means LM fusion; K in
    1..``MAX_BEAM``.  On the card ``beam_route`` picks the kernel's route
    from the shape; ``route=(C, U)`` asks for one that serves the shape
    instead (the tests hold both), ``(0, 0)`` for one block per utterance.

    ``early_exit=False`` runs the plain version's fixed trip of all
    ``max_steps``.  The kernels stop a row once its beams are all done and
    write SOS tokens and identity parents for its steps left: the fixed
    trip's frontier too, since each step's top K leaves the beams sorted, so
    a step over finished beams (their SOS candidates at no cost) keeps their
    order (``tests/test_torch_beam.py`` holds both values against JAX)."""
    if not 1 <= K <= MAX_BEAM:
        raise ValueError(f"beam_device: beam size {K} outside 1..{MAX_BEAM}")
    if enc_h.device.type == "cpu":
        return beam_scan_plain(model, enc_h, comp_h, enc_lens, K, max_steps, lm, lm_weight,
                               early_exit)
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
    if B == 0:
        return toks, parents, scores, done.bool(), hyp_len
    HL = lm.cfg.hidden_size if lm is not None else 0
    C, U = beam_route(H, F, M, V, HL, S, K, B) if route is None else route
    lib = build.load_library()
    spell = speller_operands(model, dev)
    lmw = lm_operands(lm, dev) if lm is not None else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    if C:
        plan = cluster_plan(H, F, M, V, HL, S, K, C, U)
        if plan is None:
            raise ValueError(f"beam_device: no cluster of {C} CTAs over {U} utterances serves "
                             f"H={H} F={F} M={M} HL={HL} K={K}")
        # the attention scratch past what shared memory holds: [clusters][C][S / C][rows]
        NR = U * beam_rows(K)
        att = torch.empty(0 if plan[1] else -(-B // U) * C * -(-S // C) * NR,
                          dtype=torch.float32, device=dev)
        wstream = cached_weight_stream(model, lm, spell, lmw, C)
        lm_ptrs = [w.data_ptr() for w in lmw] if lmw is not None else [None] * 11
        err = lib.ss_beam_decode_cluster(
            enc_h.data_ptr(), comp_h.data_ptr(), lens.data_ptr(), *[w.data_ptr() for w in spell],
            *[t.data_ptr() for t in (toks, parents, scores, done, hyp_len, att)],
            B, S, F, M, H, V, K, max_steps, *lm_ptrs, HL, float(lm_weight), wstream.data_ptr(),
            C, U, dev.index or 0, stream)
        build.check(err, "ss_beam_decode_cluster")
        name = "beam_decode" if lm is None else "beam_decode_lm"
        build.count_launch(LAUNCHES, name)
        build.count_launch(LAUNCHES, f"{name}_cluster")
        return toks, parents, scores, done.bool(), hyp_len
    # attention scratch for an S whose weights outgrow the shared buffer
    att = torch.empty(B, S, MAX_BEAM, dtype=torch.float32, device=dev)
    args = ([enc_h.data_ptr(), comp_h.data_ptr(), lens.data_ptr()]
            + [w.data_ptr() for w in spell]
            + [t.data_ptr() for t in (toks, parents, scores, done, hyp_len, att)]
            + [B, S, F, M, H, V, K, max_steps])
    if lm is None:
        err = lib.ss_beam_decode(*args, dev.index or 0, stream)
        build.check(err, "ss_beam_decode")
        build.count_launch(LAUNCHES, "beam_decode")
    else:
        err = lib.ss_beam_decode_lm(
            *args, *[w.data_ptr() for w in lmw], HL, float(lm_weight), dev.index or 0, stream)
        build.check(err, "ss_beam_decode_lm")
        build.count_launch(LAUNCHES, "beam_decode_lm")
    return toks, parents, scores, done.bool(), hyp_len
