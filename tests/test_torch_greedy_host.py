"""What the cluster route of K6 / K7 (the greedy decode ± char-LM,
``csrc/greedy_decode.cu``) rests on, checked here on the CPU: the route by
shape, the shared-memory plan against a hand count, and a PyTorch rendering
of the kernel's decomposition (tiles of R batch rows, each of a cluster's
C = H / 32 CTAs owning 32 units of each speller cell and their 128 gate
columns and HL / C units of each GRU, whose r, z, n columns of W_ih and
W_hh its lanes read as the kernel's lanes do, the attention split over
positions and context columns, the tile stopping once all its rows are
done) against ``greedy_decode_plain`` and the JAX package's TPU kernels
(interpret mode).

Tokens are compared exactly: the rendering sums in another order than the
plain loop (float32 differences of about 1e-7), far below the gaps between
the two best scores on these seeded inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss_asr_tpu.models import charlm as jcharlm
from ss_asr_tpu.models import las as jlas
from ss_asr_tpu.ops.pallas.decode import greedy_decode_lm_pallas, greedy_decode_pallas
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.decode.greedy import _finalize
from ss_asr_tpu_torch.models import charlm, las
from ss_asr_tpu_torch.ops.kernels import decode as kdec
from ss_asr_tpu_torch.ops.kernels import lstm as klstm
from ss_asr_tpu_torch.ops.kernels import speller_cluster as ksc
from ss_asr_tpu_torch.ops.kernels.decode import lm_operands, speller_weights
from ss_asr_tpu_torch.vocab import EOS_ID, SOS_ID, VOCAB_SIZE
from test_torch_spell_host import own_cols, warp_sum

torch.set_num_threads(1)

UNITS = ksc.SP_UNITS
FLAGSHIP = dict(H=256, F=512, M=128, S=64, V=VOCAB_SIZE)  # conf/default.yaml's speller
LM_HIDDEN = 128  # conf/default.yaml's char_lm.mdl.hidden_size


# --- the route and the shared-memory plan ----------------------------------

@pytest.mark.parametrize("HL", [0, LM_HIDDEN], ids=["greedy", "greedy+lm"])
@pytest.mark.parametrize("B,R", [(1, 1), (8, 1), (13, 1), (16, 2), (32, 4)],
                         ids=["single", "server", "13", "kernel-phase", "32"])
def test_greedy_route_by_shape(B, R, HL):
    """At the flagship width the smallest tile whose clusters of 8 CTAs are
    all resident at once (15 on the card): one row a cluster up to B = 15,
    so the server's B = 8 runs 8 clusters of one row."""
    assert kdec.greedy_route(B, **FLAGSHIP, HL=HL) == R
    assert -(-B // R) <= klstm.CARD_CLUSTERS[FLAGSHIP["H"] // 32]


@pytest.mark.parametrize("HL", [0, LM_HIDDEN], ids=["greedy", "greedy+lm"])
def test_greedy_route_past_the_card(HL):
    """B = 64 fits 15 clusters at no tile height the kernel is written for
    (1, 2, 4): it takes the largest, 16 clusters of 4 rows, which the card
    runs in two waves; tiles of 8 rows are no route."""
    assert kdec.greedy_route(64, **FLAGSHIP, HL=HL) == 4
    assert not kdec.greedy_cluster_serves(**FLAGSHIP, HL=HL, R=8)


@pytest.mark.parametrize("change", [dict(H=40), dict(H=96), dict(H=384), dict(F=500),
                                    dict(M=100), dict(V=600), dict(HL=36), dict(HL=192)],
                         ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_greedy_route_refuses_what_no_cluster_serves(change):
    """H not a multiple of 32, or 12 CTAs (H = 384); columns that do not
    split in float4s; more logits than threads; an LM whose units do not
    split in float4s (36 / 8) or whose six gate blocks pass 128 columns
    (192 / 8 = 24 units): the one-row kernel."""
    args = dict(FLAGSHIP, HL=0)
    args.update(change)
    assert kdec.greedy_route(16, **args) == 0
    if "HL" in change:  # the same speller without the LM still takes the cluster
        assert kdec.greedy_route(16, **dict(args, HL=0)) == 2


def test_greedy_route_shrinks_the_tile_with_long_memory():
    """The energies take R x S floats a CTA: a long memory leaves room for
    fewer rows a tile, then for none."""
    tiles = [kdec.greedy_route(32, **dict(FLAGSHIP, S=S), HL=LM_HIDDEN)
             for S in (64, 10_000, 20_000, 40_000)]
    assert tiles == [4, 2, 1, 0]


def test_greedy_smem_plan_by_hand():
    """K7's CTA at the flagship, tiles of 4 rows, in floats: h1, h2 (two
    steps each) 2048 + 2048, fed 1024, context 2048, query 512, energies
    256, cell carries 128 + 128, gate partials 16 x 4 x 128 = 8192, small
    products' partials 512 x 4 = 2048, own gates 512, logits 200, ct_w
    12800, ct_b 52, phi's own columns 256 x 16 = 4096, biases 256, four
    [R] index arrays 16; the LM: its input 512, g1, g2 (two steps each)
    1024 + 1024, the GRU sums 512, its logits 200, out_w 6400, out_b 52,
    both GRUs' biases 256."""
    speller = (2048 + 2048 + 1024 + 2048 + 512 + 256 + 128 + 128 + 8192 + 2048 + 512 + 200
               + 12800 + 52 + 4096 + 256 + 16)
    lm = 512 + 1024 + 1024 + 512 + 200 + 6400 + 52 + 256
    assert kdec.greedy_smem_bytes(**FLAGSHIP, HL=0, R=4) == 4 * speller
    assert kdec.greedy_smem_bytes(**FLAGSHIP, HL=LM_HIDDEN, R=4) == 4 * (speller + lm)
    assert 4 * (speller + lm) <= klstm.SMEM_BYTES


# --- a rendering of the kernel's decomposition -----------------------------

SIZES = dict(encoder_state_size=16, decoder_state_size=64, mlp_out_size=16, feature_dim=5)
LM_SMALL = 8  # 4 units a CTA of a cluster of 2


def gru_cols(c, HL, Uc):
    """CTA c's columns of a GRU's [HL, 3 HL] weights: r, z, n of its units."""
    return torch.cat([g * HL + c * Uc + torch.arange(Uc) for g in range(3)])


def gru_lanes(c, HL, Uc):
    """How CTA c's lanes read a GRU's weights (``ghid`` / ``gcol`` in
    ``greedy_cluster_kernel``): lane l sums the float4 of W_hh (hidden) or
    W_ih at column gcol into its own columns 4l .. 4l + 3 -> [(hidden,
    gcol)] for the 32 lanes.  Lanes past 6 Uc / 4 wrap onto earlier items."""
    n4 = 3 * Uc // 4
    lanes = []
    for lane in range(32):
        item = lane % (2 * n4)
        i = item % n4
        lanes.append((item >= n4, (i // (Uc // 4)) * HL + c * Uc + 4 * (i % (Uc // 4))))
    return lanes


@pytest.mark.parametrize("HL,C", [(128, 8), (8, 2), (16, 4), (40, 2)])
def test_gru_lanes_read_the_own_columns(HL, C):
    """Own columns 0 .. 6 Uc - 1 are CTA c's r, z, n columns of W_ih, then of
    W_hh: the lanes below 6 Uc / 4 read exactly those, four a lane in
    order; the lanes past them read valid columns of W_ih or W_hh, whose
    sums land in columns no gate reads."""
    Uc = HL // C
    assert 6 * Uc <= ksc.SP_COLS
    for c in range(C):
        lanes = gru_lanes(c, HL, Uc)
        own = gru_cols(c, HL, Uc).tolist()
        read = [(hid, col + k) for hid, col in lanes for k in range(4)]
        assert read[:6 * Uc] == [(False, j) for j in own] + [(True, j) for j in own]
        assert all(0 <= col and col + 4 <= 3 * HL for _, col in lanes)


def cell(g, c):
    i, f, gg, o = g.chunk(4, -1)
    cn = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(cn), cn


def gru(gi, gh, h):
    r = torch.sigmoid(gi[:, 0] + gh[:, 0])
    z = torch.sigmoid(gi[:, 1] + gh[:, 1])
    n = torch.tanh(gi[:, 2] + r * gh[:, 2])
    return (1 - z) * n + z * h


def greedy_cluster_model(model, enc_h, comp_h, enc_lens, max_steps, R, lm=None, lm_weight=0.0):
    """K6 / K7's cluster route in PyTorch -> raw tokens [B, max_steps]: tiles
    of R rows (the last padded with copies of the last row), C = H / 32 CTAs
    each scoring the positions s = c (mod C), forming F / C context columns,
    the gates of its 128 cell columns and, through its lanes' float4s of
    W_ih and W_hh, of its GRU units' columns, all gathered between the
    phases; the logits and the argmax from the gathered states; a tile
    stops once all its rows have emitted EOS, its rows' remaining steps
    SOS."""
    phi, wih1, whh1, b1, wih2, whh2, b2, ct_w, ct_b, emb = (w.detach() for w in
                                                            speller_weights(model))
    B, S, F = enc_h.shape
    H, M = whh1.shape[0], phi.shape[1]
    C = H // UNITS
    Fc, Mc = F // C, M // C
    if lm is not None:
        lemb, gi1, gh1, bi1, bh1, gi2, gh2, bi2, bh2, out_w, out_b = lm_operands(lm, enc_h.device)
        HL = lm.cfg.hidden_size
        Uc = HL // C
    out = torch.full((B, max_steps), -1, dtype=torch.int32)

    def gru_layer(x, h, wi, wh, bi, bh):
        """CTA c's lanes each sum a float4 of W_ih (over x) or W_hh (over h)
        into the 128 partial columns; the first 6 Uc, with the biases, are
        its units' input-side then hidden-side r, z, n."""
        hn = torch.empty_like(h)
        for c in range(C):
            part = torch.cat([warp_sum(h, wh[:, col:col + 4]) if hid
                              else warp_sum(x, wi[:, col:col + 4])
                              for hid, col in gru_lanes(c, HL, Uc)], -1)
            assert part.shape[1] == ksc.SP_COLS
            cols, u = gru_cols(c, HL, Uc), slice(c * Uc, (c + 1) * Uc)
            a = torch.cat([bi[cols], bh[cols]]) + part[:, :6 * Uc]
            hn[:, u] = gru(a[:, :3 * Uc].view(-1, 3, Uc), a[:, 3 * Uc:].view(-1, 3, Uc), h[:, u])
        return hn  # gathered into every CTA

    for b0 in range(0, B, R):
        rows = torch.clamp(torch.arange(b0, b0 + R), max=B - 1)
        real = torch.arange(b0, b0 + R) < B
        lens = torch.clamp(enc_lens[rows], min=1)
        h1, c1, h2, c2 = (torch.zeros(R, H) for _ in range(4))
        q, fed = torch.zeros(R, M), emb[SOS_ID].expand(R, H)
        done = torch.zeros(R, dtype=torch.bool)
        if lm is not None:
            g1, g2, lx = torch.zeros(R, HL), torch.zeros(R, HL), lemb[SOS_ID].expand(R, HL)
        for t in range(max_steps):
            e = torch.empty(R, S)
            for c in range(C):  # (1) CTA c's positions
                s = torch.arange(c, S, C)
                e[:, s] = torch.einsum("rsm,rm->rs", comp_h[rows][:, s], q)
            e = torch.where(torch.arange(S)[None] < lens[:, None], e, -torch.inf)
            a = torch.softmax(e, -1)  # (2) in every CTA alike
            ctx = torch.cat([torch.einsum("rs,rsf->rf", a, enc_h[rows][:, :, c * Fc:(c + 1) * Fc])
                             for c in range(C)], -1)
            if lm is not None:  # the LM's first GRU, behind barrier (1)
                g1n = gru_layer(lx, g1, gi1, gh1, bi1, bh1)
            h1n, c1n, h2n, c2n = (torch.empty(R, H) for _ in range(4))
            for c in range(C):  # (3) cell 1 of CTA c's units
                cols, u = own_cols(c, H), slice(c * UNITS, (c + 1) * UNITS)
                g = (b1[cols] + warp_sum(fed, wih1[:H, cols]) + warp_sum(ctx, wih1[H:, cols])
                     + warp_sum(h1, whh1[:, cols]))
                h1n[:, u], c1n[:, u] = cell(g, c1[:, u])
            if lm is not None:  # the LM's second GRU, behind barrier (3)
                g2n = gru_layer(g1n, g2, gi2, gh2, bi2, bh2)
            qn = torch.empty(R, M)
            for c in range(C):  # (4) cell 2 and the next query's columns
                cols, u = own_cols(c, H), slice(c * UNITS, (c + 1) * UNITS)
                g = b2[cols] + warp_sum(h2, whh2[:, cols]) + warp_sum(h1n, wih2[:, cols])
                h2n[:, u], c2n[:, u] = cell(g, c2[:, u])
                m = slice(c * Mc, (c + 1) * Mc)
                qn[:, m] = torch.tanh(h1n @ phi[:, m])
            score = h2n @ ct_w + ct_b  # (5) in every CTA alike, from the gathered h2
            if lm is not None:
                score = (torch.log_softmax(score, -1)
                         + lm_weight * torch.log_softmax(g2n @ out_w + out_b, -1))
            ids = torch.argmax(score, -1)
            tok = torch.where(done, torch.full_like(ids, SOS_ID), ids).to(torch.int32)
            out[rows[real], t] = tok[real]
            done = done | (ids == EOS_ID)
            h1, c1, h2, c2, q, fed = h1n, c1n, h2n, c2n, qn, emb[ids]
            if lm is not None:
                g1, g2, lx = g1n, g2n, lemb[ids]
            if bool(done.all()):  # the tile stops; its rows' rest is SOS
                out[rows[real], t + 1:] = SOS_ID
                break
    assert (out >= 0).all()
    return out


def _jax_models(seed, lm_hidden=LM_SMALL, eos_bias=None, gain=1.0):
    """JAX parameters at SIZES (every weight but the embedding table times
    ``gain``) and the port's models converted from them."""
    jcfg = jlas.ASRConfig(**SIZES)
    jp = jax.tree.map(np.asarray, jlas.init_asr(jax.random.key(seed), jcfg))
    jp = {k: v if k == "embed" else jax.tree.map(lambda a: a * np.float32(gain), v)
          for k, v in jp.items()}
    if eos_bias is not None:
        jp["char_trans"]["b"] = jp["char_trans"]["b"].copy()
        jp["char_trans"]["b"][EOS_ID] = eos_bias
    model = las.LAS(las.ASRConfig(**SIZES))
    model.load_state_dict(convert.asr_state_from_params(jp))
    jlm = jax.tree.map(np.asarray, jcharlm.init_charlm(
        jax.random.key(seed + 100), jcharlm.CharLMConfig(hidden_size=lm_hidden)))
    lm = charlm.CharLM(charlm.CharLMConfig(hidden_size=lm_hidden))
    lm.load_state_dict(convert.charlm_state_from_params(jlm))
    return jcfg, jp, jlm, model.eval(), lm.eval()


def _memory(model, x, xl):
    with torch.inference_mode():
        enc_h, enc_lens = las.listener_apply(model.encoder, torch.from_numpy(x),
                                             torch.from_numpy(xl))
        return enc_h, las.attention_precompute(model.attention, enc_h), enc_lens


# At the initial scale the listener's output barely varies (std about
# 0.006) and every row decodes the same tokens; ten times the weights (the
# embedding table aside) and this EOS bias make rows end at steps 0-2 or run
# all 14 (with and without the LM), so that tiles hold done and running rows
# and some stop early.
GAIN, EOS_BIAS = 10.0, 2.75


@pytest.mark.parametrize("R", kdec.GREEDY_TILE_ROWS)
@pytest.mark.parametrize("use_lm", [False, True], ids=["greedy", "greedy+lm"])
def test_cluster_decomposition_equals_plain_and_the_pallas_kernels(rng, use_lm, R):
    """B = 5 (a multiple of no tile height but 1), lengths ragged down to 0,
    rows ending at different steps: the rendering's raw tokens equal
    greedy_decode_plain's, and after ``_finalize`` the tokens and lengths of
    the TPU kernels ``greedy_decode_pallas`` / ``greedy_decode_lm_pallas``
    in interpret mode."""
    jcfg, jp, jlm, model, lm = _jax_models(7, eos_bias=EOS_BIAS, gain=GAIN)
    lm_ = lm if use_lm else None
    x = rng.standard_normal((5, 40, 5)).astype(np.float32)
    xl = np.asarray([40, 33, 0, 17, 9], np.int32)
    steps = 14
    enc_h, comp_h, enc_lens = _memory(model, x, xl)
    HL = LM_SMALL if use_lm else 0
    assert kdec.greedy_cluster_serves(64, enc_h.shape[2], 16, enc_h.shape[1], VOCAB_SIZE, HL, R)
    with torch.no_grad():
        got = greedy_cluster_model(model, enc_h, comp_h, enc_lens, steps, R, lm_, 0.5)
        want = kdec.greedy_decode_plain(model, enc_h, comp_h, enc_lens, steps, lm_, 0.5)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    ends = [(r == EOS_ID).nonzero()[0] for r in got.numpy()]
    assert len({int(e[0]) if e.size else steps for e in ends}) > 2  # rows end apart
    if use_lm:
        want_t, want_l = greedy_decode_lm_pallas(jp, jcfg, jnp.asarray(x), jnp.asarray(xl), jlm,
                                                 0.5, max_steps=steps, interpret=True)
    else:
        want_t, want_l = greedy_decode_pallas(jp, jcfg, jnp.asarray(x), jnp.asarray(xl),
                                              max_steps=steps, interpret=True)
    got_t, got_l = _finalize(got, steps)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


@pytest.mark.parametrize("use_lm", [False, True], ids=["greedy", "greedy+lm"])
def test_cluster_decomposition_stops_tiles_early(rng, use_lm):
    """A large EOS bias: every row ends at step 0, every tile stops after
    one step and pads its rows' remaining steps with SOS, as the plain
    decode's done rows."""
    _, _, _, model, lm = _jax_models(8, eos_bias=50.0)
    x = rng.standard_normal((7, 24, 5)).astype(np.float32)
    enc_h, comp_h, enc_lens = _memory(model, x, np.asarray([24, 3, 24, 0, 11, 24, 5], np.int32))
    lm_ = lm if use_lm else None
    with torch.no_grad():
        got = greedy_cluster_model(model, enc_h, comp_h, enc_lens, 9, 2, lm_, 0.5)
        want = kdec.greedy_decode_plain(model, enc_h, comp_h, enc_lens, 9, lm_, 0.5)
    assert (got[:, 0] == EOS_ID).all() and (got[:, 1:] == SOS_ID).all()
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("use_lm", [False, True], ids=["greedy", "greedy+lm"])
def test_cluster_decomposition_at_four_ctas(rng, use_lm):
    """H = 128: a cluster of 4 CTAs, the LM's 16 units 4 a CTA; B = 6 in
    tiles of 4."""
    sizes = dict(SIZES, decoder_state_size=128)
    torch.manual_seed(3)
    model = las.LAS(las.ASRConfig(**sizes)).eval()
    lm = charlm.CharLM(charlm.CharLMConfig(hidden_size=16)).eval()
    x = torch.from_numpy(rng.standard_normal((6, 32, 5)).astype(np.float32))
    with torch.inference_mode():
        enc_h, enc_lens = las.listener_apply(model.encoder, x, torch.tensor([32, 7, 1, 20, 32, 13]))
        comp_h = las.attention_precompute(model.attention, enc_h)
    lm_ = lm if use_lm else None
    assert kdec.greedy_cluster_serves(128, enc_h.shape[2], 16, enc_h.shape[1], VOCAB_SIZE,
                                      16 if use_lm else 0, 4)
    with torch.no_grad():
        got = greedy_cluster_model(model, enc_h, comp_h, enc_lens, 12, 4, lm_, 0.7)
        want = kdec.greedy_decode_plain(model, enc_h, comp_h, enc_lens, 12, lm_, 0.7)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
