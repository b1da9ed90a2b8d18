"""The port's beam search (± char-LM fusion) against the JAX package.

On the CPU the port's frontier wrapper runs ``beam_scan_plain``, the
reference its CUDA kernel K8 is held to on the card.  Here, on the same
numpy inputs and the same JAX parameters (converted with ``convert.py``),
its frontier trace must equal JAX's XLA scan ``_beam_scan`` and the TPU
kernel ``beam_device_pallas`` in interpret mode: tokens, parents, done
flags and hypothesis lengths exactly, final scores within 1e-5 (float32
sums of up to a dozen log-probs, taken in another order).  The backtracked
transcripts (best and n-best, with and without length normalisation) must
be equal, under both values of ``early_exit`` (``False`` runs all
``max_steps``, as JAX's fixed-trip scan does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss_asr_tpu.decode import beam as jbeam
from ss_asr_tpu.models import charlm as jcharlm
from ss_asr_tpu.models import las as jlas
from ss_asr_tpu.ops.pallas.beam import beam_device_pallas
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.decode import beam
from ss_asr_tpu_torch.models import charlm, las
from ss_asr_tpu_torch.ops import rnn
from ss_asr_tpu_torch.ops.kernels.beam import MAX_BEAM, beam_device
from ss_asr_tpu_torch.vocab import EOS_ID

torch.set_num_threads(1)

SIZES = dict(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=5)
JCFG = jlas.ASRConfig(**SIZES)
LCFG = jcharlm.CharLMConfig(hidden_size=8)
SCORE_TOL = 1e-5


def _models(seed, eos_bias=None):
    jp = jax.tree.map(np.asarray, jlas.init_asr(jax.random.key(seed), JCFG))
    if eos_bias is not None:
        jp["char_trans"]["b"] = jp["char_trans"]["b"].copy()
        jp["char_trans"]["b"][EOS_ID] = eos_bias
    model = las.LAS(las.ASRConfig(**SIZES))
    model.load_state_dict(convert.asr_state_from_params(jp))
    jlm = jax.tree.map(np.asarray, jcharlm.init_charlm(jax.random.key(seed + 100), LCFG))
    lm = charlm.CharLM(charlm.CharLMConfig(hidden_size=8))
    lm.load_state_dict(convert.charlm_state_from_params(jlm))
    return jp, model.eval(), jlm, lm.eval()


def _inputs(rng, lens, T=16):
    x = rng.standard_normal((len(lens), T, 5)).astype(np.float32)
    return x, np.asarray(lens, np.int32)


def _port_frontier(model, x, lens, K, T, lm=None, lm_weight=0.0, early_exit=True):
    with torch.inference_mode():
        enc_h, enc_lens = las.listener_apply(model.encoder, torch.from_numpy(x),
                                             torch.from_numpy(lens))
        comp_h = las.attention_precompute(model.attention, enc_h)
        out = beam_device(model, enc_h, comp_h, enc_lens, K, T, lm, lm_weight,
                          early_exit=early_exit)
    return [o.numpy() for o in out]


def _assert_frontier_equal(got, want):
    names = ("toks", "parents", "scores", "done", "hyp_len")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        if name == "scores":
            np.testing.assert_allclose(g, w, rtol=0, atol=SCORE_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("use_lm", [False, True], ids=["beam", "beam+lm"])
def test_frontier_matches_xla_scan(rng, K, use_lm):
    jp, model, jlm, lm = _models(K)
    x, xl = _inputs(rng, [16, 9, 3])
    T, w = 10, (0.6 if use_lm else 0.0)
    want = jbeam._beam_device(jp, JCFG, jnp.asarray(x), jnp.asarray(xl), K, T,
                              jlm if use_lm else None, LCFG, w, early_exit=True)
    got = _port_frontier(model, x, xl, K, T, lm if use_lm else None, w)
    _assert_frontier_equal(got, want)


@pytest.mark.parametrize("K,use_lm", [(1, False), (3, True), (8, False)])
def test_frontier_matches_pallas_kernel(rng, K, use_lm):
    jp, model, jlm, lm = _models(10 + K)
    x, xl = _inputs(rng, [16, 11])
    T, w = 8, (0.4 if use_lm else 0.0)
    want = beam_device_pallas(jp, JCFG, jnp.asarray(x), jnp.asarray(xl), beam_size=K,
                              max_steps=T, lm_params=jlm if use_lm else None, lm_cfg=LCFG,
                              lm_weight=w, interpret=True)
    got = _port_frontier(model, x, xl, K, T, lm if use_lm else None, w)
    _assert_frontier_equal(got, want)


@pytest.mark.parametrize("use_lm", [False, True], ids=["beam", "beam+lm"])
def test_early_exit_equals_fixed_trip(rng, use_lm):
    """An EOS bias ends every beam within a few steps: the port's early exit
    must leave exactly the fixed-trip scan's SOS tokens, identity parents
    and scores behind."""
    jp, model, jlm, lm = _models(5, eos_bias=2.5)
    x, xl = _inputs(rng, [16, 12])
    K, T, w = 3, 12, (0.5 if use_lm else 0.0)
    got = _port_frontier(model, x, xl, K, T, lm if use_lm else None, w)
    assert got[3].all(), "every beam should finish before max_steps"
    assert (got[0][-1] == 0).all() and (got[1][-1] == np.arange(K)).all()
    want = jbeam._beam_device(jp, JCFG, jnp.asarray(x), jnp.asarray(xl), K, T,
                              jlm if use_lm else None, LCFG, w, early_exit=False)
    _assert_frontier_equal(got, want)


@pytest.mark.parametrize("length_norm", [False, True], ids=["sum", "length_norm"])
@pytest.mark.parametrize("use_lm", [False, True], ids=["beam", "beam+lm"])
def test_beam_decode_and_nbest_match_jax(rng, length_norm, use_lm):
    jp, model, jlm, lm = _models(20, eos_bias=0.8)
    x, xl = _inputs(rng, [16, 10, 14])
    kw = dict(beam_size=4, max_steps=10, lm_weight=0.5 if use_lm else 0.0,
              length_norm=length_norm)
    want_t, want_l = jbeam.beam_decode(jp, JCFG, jnp.asarray(x), jnp.asarray(xl),
                                       lm_params=jlm if use_lm else None, lm_cfg=LCFG, **kw)
    xt, lt = torch.from_numpy(x), torch.from_numpy(xl)
    got_t, got_l = beam.beam_decode(model, xt, lt, lm=lm if use_lm else None, **kw)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_l, want_l)
    want = jbeam.beam_decode_nbest(jp, JCFG, jnp.asarray(x), jnp.asarray(xl),
                                   lm_params=jlm if use_lm else None, lm_cfg=LCFG, n_best=3,
                                   **kw)
    got = beam.beam_decode_nbest(model, xt, lt, lm=lm if use_lm else None, n_best=3, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("early_exit", [True, False], ids=["early_exit", "fixed_trip"])
@pytest.mark.parametrize("use_lm", [False, True], ids=["beam", "beam+lm"])
def test_early_exit_keyword_matches_jax(rng, monkeypatch, early_exit, use_lm):
    """``early_exit=`` as JAX takes it: ``True`` stops once every beam is
    done, ``False`` runs all ``max_steps`` (the speller steps counted); the
    frontier, ``beam_decode`` and ``beam_decode_nbest`` equal JAX's under
    the same value."""
    jp, model, jlm, lm = _models(5, eos_bias=2.5)
    x, xl = _inputs(rng, [16, 12])
    K, T, w = 3, 12, (0.5 if use_lm else 0.0)
    port_lm, jax_lm = (lm, jlm) if use_lm else (None, None)
    calls = []
    step = las.speller_step
    monkeypatch.setattr(las, "speller_step", lambda *a: (calls.append(1), step(*a))[1])
    got = _port_frontier(model, x, xl, K, T, port_lm, w, early_exit=early_exit)
    n_steps = len(calls) - 1  # the last call charges the still-open beams' EOS
    assert n_steps == T if not early_exit else 0 < n_steps < T
    want = jbeam._beam_device(jp, JCFG, jnp.asarray(x), jnp.asarray(xl), K, T, jax_lm, LCFG, w,
                              early_exit=early_exit)
    _assert_frontier_equal(got, want)
    kw = dict(beam_size=K, max_steps=T, lm_weight=w, early_exit=early_exit)
    xt, lt = torch.from_numpy(x), torch.from_numpy(xl)
    want_t, want_l = jbeam.beam_decode(jp, JCFG, jnp.asarray(x), jnp.asarray(xl),
                                       lm_params=jax_lm, lm_cfg=LCFG, **kw)
    got_t, got_l = beam.beam_decode(model, xt, lt, lm=port_lm, **kw)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_l, want_l)
    want = jbeam.beam_decode_nbest(jp, JCFG, jnp.asarray(x), jnp.asarray(xl), lm_params=jax_lm,
                                   lm_cfg=LCFG, n_best=2, **kw)
    got = beam.beam_decode_nbest(model, xt, lt, lm=port_lm, n_best=2, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=SCORE_TOL)


def test_beam_size_outside_the_kernel_range_raises(rng):
    _, model, _, _ = _models(0)
    x, xl = _inputs(rng, [16])
    with pytest.raises(ValueError, match=f"outside 1..{MAX_BEAM}"):
        _port_frontier(model, x, xl, MAX_BEAM + 1, 4)
    with pytest.raises(ValueError, match="n_best must be >= 1"):
        beam.beam_decode_nbest(model, torch.from_numpy(x), torch.from_numpy(xl), n_best=0)


def cluster_step_model(model, lm, enc, comp, lens, last, state, lm_state, C):
    """numpy (float64) model of one step of K8's cluster route for every row:
    CTA c owns H/C speller units, M/C query columns, F/C context features,
    HL/C LM units and ceil(V/C) LM logit columns, and reads its gate columns
    from its panels of ``weight_stream``; the attention is split over s in C
    ranges, each with its own max and sum of exp, merged by the owners of
    the features; the logits are the sum of each CTA's partial over its own
    units.  Returns (logits, LM logits, ((h1, c1), (h2, c2)), (g1, g2))."""
    from ss_asr_tpu_torch.ops.kernels.beam import weight_stream
    from ss_asr_tpu_torch.ops.kernels.decode import speller_weights

    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    ws = [w.detach().double() for w in speller_weights(model)]
    lws = [lm.emb.weight]  # lm_operands' order, in float64
    for g in (lm.layer_1, lm.layer_2):
        lws += [g.weight_ih.t(), g.weight_hh.t(), g.bias_ih, g.bias_hh]
    lws = [w.detach().double().contiguous() for w in lws + [lm.out.weight.t(), lm.out.bias]]
    stream = weight_stream(ws, lws, C).numpy()
    phi, _, _, b1, _, _, b2, ct_w, ct_b, emb = (w.numpy() for w in ws)
    l_emb, _, _, bih1, bhh1, _, _, bih2, bhh2, out_w, out_b = (w.numpy() for w in lws)
    (h1, c1), (h2, c2) = state
    g1, g2 = lm_state
    Bn, S, F = enc.shape
    H, M, V, HL = h1.shape[1], comp.shape[2], ct_b.shape[0], g1.shape[1]
    Hc, Fc, Mc, HLc, Vc, Sc = H // C, F // C, M // C, HL // C, -(-V // C), -(-S // C)
    rows = np.cumsum([0, HL, HL, 2 * H + F, 2 * H])  # the panels' first rows

    def gru(x, h, panel, bi, bh):
        out = np.zeros_like(h)
        for c in range(C):
            P = stream[c, rows[panel]:rows[panel + 1]]
            a = x @ P[:, :3 * HLc] + bi[[g * HL + c * HLc + j for g in range(3) for j in range(HLc)]]
            b = h @ P[:, 3 * HLc:6 * HLc] + bh[[g * HL + c * HLc + j for g in range(3)
                                                  for j in range(HLc)]]
            r, z = sig(a[:, :HLc] + b[:, :HLc]), sig(a[:, HLc:2 * HLc] + b[:, HLc:2 * HLc])
            n = np.tanh(a[:, 2 * HLc:] + r * b[:, 2 * HLc:])
            own = slice(c * HLc, (c + 1) * HLc)
            out[:, own] = (1 - z) * n + z * h[:, own]
        return out

    def lstm(x, c_old, panel, bias):
        h_new, c_new = np.zeros_like(c_old), np.zeros_like(c_old)
        for c in range(C):
            a = x @ stream[c, rows[panel]:rows[panel + 1]] + bias[
                [g * H + c * Hc + j for g in range(4) for j in range(Hc)]]
            own = slice(c * Hc, (c + 1) * Hc)
            c_new[:, own] = sig(a[:, Hc:2 * Hc]) * c_old[:, own] + sig(a[:, :Hc]) * np.tanh(
                a[:, 2 * Hc:3 * Hc])
            h_new[:, own] = sig(a[:, 3 * Hc:]) * np.tanh(c_new[:, own])
        return h_new, c_new

    q = np.concatenate([np.tanh(h1 @ phi[:, c * Mc:(c + 1) * Mc]) for c in range(C)], 1)
    g1n = gru(l_emb[last], g1, 0, bih1, bhh1)
    # each CTA's range of memory steps: its max, its sum of exp, its unnormalised context
    mx, den, part = [], [], []
    for c in range(C):
        s = np.arange(c * Sc, min(S, (c + 1) * Sc))
        e = np.einsum("bsm,bm->bs", comp[:, s], q)
        e = np.where(s[None, :] < lens[:, None], e, -np.inf)
        m = e.max(1, initial=-np.inf)
        w = np.where(np.isfinite(m)[:, None], np.exp(e - np.where(np.isfinite(m), m, 0)[:, None]), 0)
        mx.append(m)
        den.append(w.sum(1))
        part.append(np.einsum("bs,bsf->bf", w, enc[:, s]))
    g2n = gru(g1n, g2, 1, bih2, bhh2)
    # the owner of features [c*Fc, (c+1)*Fc) merges the partials
    top = np.max(mx, 0)
    scale = [np.where(np.isfinite(m), np.exp(m - top), 0.0) for m in mx]
    ctx = np.zeros((Bn, F))
    for c in range(C):
        f = slice(c * Fc, (c + 1) * Fc)
        ctx[:, f] = sum(p[:, f] * sc[:, None] for p, sc in zip(part, scale)) / sum(
            d * sc for d, sc in zip(den, scale))[:, None]
    lm_logits = np.concatenate([g2n @ out_w[:, c * Vc:(c + 1) * Vc] + out_b[c * Vc:(c + 1) * Vc]
                                for c in range(C)], 1)
    h1n, c1n = lstm(np.concatenate([emb[last], ctx, h1], 1), c1, 2, b1)
    h2n, c2n = lstm(np.concatenate([h1n, h2], 1), c2, 3, b2)
    logits = ct_b + sum(h2n[:, c * Hc:(c + 1) * Hc] @ ct_w[c * Hc:(c + 1) * Hc] for c in range(C))
    return logits, lm_logits, ((h1n, c1n), (h2n, c2n)), (g1n, g2n)


@pytest.mark.parametrize("H,enc_state,M,HL,C", [(64, 32, 32, 32, 2), (128, 64, 32, 32, 4),
                                                (128, 64, 32, 32, 8)])
def test_cluster_step_decomposition_equals_the_plain_step(H, enc_state, M, HL, C):
    """In float64, at streams of 128 and 64 columns a CTA (the route serves
    128 only): the weight stream's column split, the per-CTA attention
    with its max / sum merge and the reduce-scattered context, the GRU and
    LSTM cells of each CTA's units and the logits as a sum of per-CTA
    partials give the plain step of ``beam_scan_plain`` (attention, the two
    speller cells, the character projection and the LM step) on random
    states, ragged memory lengths (one of 1) included."""
    from ss_asr_tpu_torch.ops.kernels.beam import beam_route, cluster_plan

    cfg = las.ASRConfig(encoder_state_size=enc_state, decoder_state_size=H, mlp_out_size=M,
                        feature_dim=5)
    jp = jax.tree.map(np.asarray, jlas.init_asr(jax.random.key(5), jlas.ASRConfig(
        encoder_state_size=enc_state, decoder_state_size=H, mlp_out_size=M, feature_dim=5)))
    model = las.LAS(cfg)
    model.load_state_dict(convert.asr_state_from_params(jp))
    lcfg = charlm.CharLMConfig(hidden_size=HL)
    lm = charlm.CharLM(lcfg)
    lm.load_state_dict(convert.charlm_state_from_params(convert.init_charlm_numpy(6, lcfg)))
    model, lm = model.double().eval(), lm.double().eval()
    F, V = cfg.enc_out_dim, cfg.vocab_size
    assert (cluster_plan(H, F, M, V, HL, 11, 3, C, 1) is not None) == (4 * H == 128 * C)
    assert beam_route(H, F, M, V, HL, 11, 3, 6)[0] == 4 * H // 128
    rng = np.random.default_rng(C)
    Bn, S = 6, 11
    enc = rng.standard_normal((Bn, S, F))
    lens = np.array([11, 1, 7, 3, 10, 6])
    last = rng.integers(0, V, Bn)
    st = [0.5 * rng.standard_normal((Bn, n)) for n in (H, H, H, H, HL, HL)]
    with torch.no_grad():
        comp = las.attention_precompute(model.attention, torch.from_numpy(enc)).numpy()
        got = cluster_step_model(model, lm, enc, comp, lens, last, ((st[0], st[1]), (st[2], st[3])),
                                 (st[4], st[5]), C)
        t = lambda a: torch.from_numpy(a)
        _, context = las.attention_step(model.attention, t(comp), t(enc), t(st[0]),
                                        las.attention_mask(t(lens), S))
        ids = torch.from_numpy(last)
        state, out = las.speller_step(model.decoder, torch.cat([rnn.embed(model.embed, ids), context], -1),
                                      ((t(st[0]), t(st[1])), (t(st[2]), t(st[3]))))
        logits = rnn.linear(model.char_trans, out)
        lm_logits, lm_state = charlm.step(lm, ids, (t(st[4]), t(st[5])))
    want = (logits, lm_logits, state, lm_state)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(lambda a: a.numpy(), want))):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-11)
