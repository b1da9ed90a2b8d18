"""What the cluster route of K9 and K10 (the attend-and-spell forward and
backward, ``csrc/spell_fwd.cu`` / ``csrc/spell_bwd.cu``) rests on, checked
here on the CPU: the route by shape, the shared-memory plans, a PyTorch
rendering of the kernels' decomposition (tiles of R batch rows, each of a
cluster's C = H / 32 CTAs owning 32 units of each cell and their 128 gate
columns, the attention split over positions and context columns, the
transposed products as per-CTA partial sums that the cluster reduces)
against the plain versions, and the backward from the forward's stored
gates against the recompute path and the JAX package's TPU kernel
(interpret mode).

Tolerance 1e-5: float32 sums of at most a few hundred products taken in
another order than the plain loops take them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss_asr_tpu.ops.pallas import spell as jspell
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops.kernels import lstm as klstm
from ss_asr_tpu_torch.ops.kernels import spell as kspell
from ss_asr_tpu_torch.ops.kernels import speller_cluster as ksc
from ss_asr_tpu_torch.ops.kernels.decode import speller_weights
from ss_asr_tpu_torch.vocab import SOS_ID, VOCAB_SIZE

torch.set_num_threads(1)

TOL = 1e-5
FLAGSHIP = dict(F=512, M=128, S=64, V=VOCAB_SIZE)  # conf/default.yaml's speller and memory
WARPS = ksc.SP_WARPS
UNITS = ksc.SP_UNITS


# --- the route and the shared-memory plans ---------------------------------

@pytest.mark.parametrize("B", [8, 16, 32, 64])
@pytest.mark.parametrize("H,C", [(128, 4), (256, 8), (384, 0)])
def test_spell_route_by_shape(B, H, C):
    """H / 32 CTAs a cluster up to 8 (H = 384 would need 12: the one-row
    kernels); tiles of 4 rows while the clusters all fit on the card at
    once, so the TAE's B = 64 at H = 256 (16 clusters of 8 where 15 fit)
    takes tiles of 5."""
    R = kspell.spell_route(B, H, **FLAGSHIP)
    if C == 0:
        assert R == 0
        return
    assert R in kspell.TILE_ROWS and kspell.cluster_serves(H, R=R, **FLAGSHIP)
    assert R == (5 if (H, B) == (256, 64) else 4)
    assert -(-B // R) <= klstm.CARD_CLUSTERS[C]


@pytest.mark.parametrize("shape", [dict(B=32, S=64), dict(B=64, S=48), dict(B=16, S=64)],
                         ids=["asr", "tae", "detail"])
def test_cluster_plans_fit_at_the_trained_shapes(shape):
    """The ASR step, the TAE step and the alignment pass: every tile height
    fits both CTAs' buffers in one block's shared memory at the flagship
    width, and the route takes the cluster."""
    dims = dict(FLAGSHIP, S=shape["S"])
    for R in kspell.TILE_ROWS:
        for plan in (kspell.spell_fwd_smem_bytes, kspell.spell_bwd_smem_bytes):
            assert plan(256, R=R, **dims) <= klstm.SMEM_BYTES
    assert kspell.spell_route(shape["B"], 256, **dims) in kspell.TILE_ROWS


@pytest.mark.parametrize("change", [dict(H=384), dict(H=96), dict(H=8), dict(F=500),
                                    dict(M=100), dict(V=600), dict(S=4096), dict(R=3)],
                         ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_cluster_refuses_what_it_does_not_serve(change):
    args = dict(H=256, R=4, **FLAGSHIP)
    args.update(change)
    assert not kspell.cluster_serves(**args)
    if "R" not in change:
        assert kspell.spell_route(32, **{k: v for k, v in args.items() if k != "R"}) == 0


def test_smem_plans_grow_with_the_tile_and_the_memory():
    small = kspell.spell_bwd_smem_bytes(256, R=4, **FLAGSHIP)
    assert kspell.spell_bwd_smem_bytes(256, R=8, **FLAGSHIP) > small
    assert kspell.spell_bwd_smem_bytes(256, R=4, **dict(FLAGSHIP, S=128)) > small
    assert (kspell.spell_fwd_smem_bytes(256, R=8, **FLAGSHIP)
            > kspell.spell_fwd_smem_bytes(256, R=4, **FLAGSHIP))


# --- a rendering of the kernels' decomposition -----------------------------

SIZES = dict(encoder_state_size=16, decoder_state_size=64, mlp_out_size=16, feature_dim=5)


def own_cols(c, H):
    """CTA c's gate columns q * H + 32 c + j, in its own order q * 32 + j."""
    return torch.cat([q * H + c * UNITS + torch.arange(UNITS) for q in range(4)])


def warp_sum(x, W):
    """x @ W as the kernel's 16 warps take it: warp w sums the rows k = w
    (mod 16), and the warps' partials meet in warp order."""
    out = 0.0
    for w in range(WARPS):
        out = out + x[:, w::WARPS] @ W[w::WARPS]
    return out


def fwd_model(model, enc_h, comp_h, enc_lens, tf_draws, gumbel, temb, R):
    """K9's cluster route in PyTorch: tiles of R rows (the last padded with
    copies of the last row), C = H / 32 CTAs each scoring the positions
    s = c (mod C), forming F / C context columns and the gates of its 128
    columns, all-gathered between the phases."""
    phi, wih1, whh1, b1, wih2, whh2, b2, ct_w, ct_b, emb = (w.detach() for w in
                                                            speller_weights(model))
    B, S, F = enc_h.shape
    L, H, M = tf_draws.shape[0], whh1.shape[0], phi.shape[1]
    C = H // UNITS
    Fc, Mc = F // C, M // C
    outs = [torch.zeros(L, B, n) for n in (VOCAB_SIZE, S, H, H, H, H, H, 4 * H, 4 * H)]

    def cell(g, c):
        i, f, gg, o = g.chunk(4, -1)
        cn = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        return torch.sigmoid(o) * torch.tanh(cn), cn

    for b0 in range(0, B, R):
        rows = torch.clamp(torch.arange(b0, b0 + R), max=B - 1)
        real = torch.arange(b0, b0 + R) < B
        lens = torch.clamp(enc_lens[rows], min=1)
        h1, c1, h2, c2 = (torch.zeros(R, H) for _ in range(4))
        fed, q = emb[SOS_ID].expand(R, H), torch.zeros(R, M)
        for t in range(L):
            e = torch.empty(R, S)
            for c in range(C):  # (1) CTA c's positions
                s = torch.arange(c, S, C)
                e[:, s] = torch.einsum("rsm,rm->rs", comp_h[rows][:, s], q)
            e = torch.where(torch.arange(S)[None] < lens[:, None], e, -torch.inf)
            a = torch.softmax(e, -1)
            ctx = torch.cat([torch.einsum("rs,rsf->rf", a, enc_h[rows][:, :, c * Fc:(c + 1) * Fc])
                             for c in range(C)], -1)  # (2) CTA c's context columns
            g1, g2 = torch.empty(R, 4 * H), torch.empty(R, 4 * H)
            h1n, c1n, h2n, c2n = (torch.empty(R, H) for _ in range(4))
            for c in range(C):  # (3) cell 1 of CTA c's units
                cols, u = own_cols(c, H), slice(c * UNITS, (c + 1) * UNITS)
                g1[:, cols] = (b1[cols] + warp_sum(fed, wih1[:H, cols])
                               + warp_sum(ctx, wih1[H:, cols]) + warp_sum(h1, whh1[:, cols]))
                h1n[:, u], c1n[:, u] = cell(g1[:, cols], c1[:, u])
            qn = torch.empty(R, M)
            for c in range(C):  # (4) cell 2 and the next query's columns
                cols, u = own_cols(c, H), slice(c * UNITS, (c + 1) * UNITS)
                g2[:, cols] = b2[cols] + warp_sum(h2, whh2[:, cols]) + warp_sum(h1n, wih2[:, cols])
                h2n[:, u], c2n[:, u] = cell(g2[:, cols], c2[:, u])
                m = slice(c * Mc, (c + 1) * Mc)
                qn[:, m] = torch.tanh(h1n @ phi[:, m])
            logits = h2n @ ct_w + ct_b  # (5) in every CTA alike
            ids = torch.argmax(logits + gumbel[t, rows], -1)
            fed = torch.where(tf_draws[t] > 0.5, temb[t, rows], emb[ids])
            h1, c1, h2, c2, q = h1n, c1n, h2n, c2n, qn
            for o, v in zip(outs, (logits, a, h1, c1, h2, c2, fed, g1, g2)):
                o[t, rows[real]] = v[real]
    return tuple(outs)


def bwd_model(enc_h, comp_h, dlogits, daext, streams, gates, W, R):
    """K10's cluster route in PyTorch: per tile of R rows, each CTA's cell
    adjoints on its own units from the stored gates, the transposed products
    as per-CTA partial sums over its 128 gate rows of [W_ih | W_hh]^T that
    the cluster reduce-scatters, da all-reduced over the CTAs' context
    columns, dqpre per CTA query columns, and its phi^T partials reaching
    the next step's dh1."""
    phi, wih1, whh1, _, wih2, whh2, _, ct_w, _, emb = W
    a, h1s, c1s, h2s, c2s, _ = streams
    g1s, g2s = gates
    L, B, S = a.shape
    H, F, M = h1s.shape[2], enc_h.shape[2], phi.shape[1]
    C = H // UNITS
    Fc, Mc = F // C, M // C
    wt1 = torch.cat([wih1, whh1]).t()  # [4H, 2H + F]
    wt2 = torch.cat([wih2, whh2]).t()  # [4H, 2H]
    outs = [torch.zeros(L, B, n) for n in (4 * H, 4 * H, S, M, H)]

    def adjoint(g, dh, dc, c, c_p):
        i, f, o = (torch.sigmoid(g[:, k * UNITS:(k + 1) * UNITS]) for k in (0, 1, 3))
        gg = torch.tanh(g[:, 2 * UNITS:3 * UNITS])
        tc = torch.tanh(c)
        dct = dh * o * (1 - tc * tc) + dc
        return (torch.cat([dct * gg * i * (1 - i), dct * c_p * f * (1 - f),
                           dct * i * (1 - gg * gg), dh * tc * o * (1 - o)], -1), dct * f)

    for b0 in range(0, B, R):
        rows = torch.clamp(torch.arange(b0, b0 + R), max=B - 1)
        real = torch.arange(b0, b0 + R) < B
        dh1c, dc1c, dh2c, dc2c, pending = (torch.zeros(R, H) for _ in range(5))
        for t in range(L - 1, -1, -1):
            prev = (lambda s: s[t - 1, rows]) if t > 0 else (lambda s: torch.zeros(R, H))
            dg2, dg1 = torch.empty(R, 4 * H), torch.empty(R, 4 * H)
            tot2 = 0.0
            for c in range(C):  # (1) cell 2 of CTA c's units, its partial of the products
                cols, u = own_cols(c, H), slice(c * UNITS, (c + 1) * UNITS)
                dh = dh2c[:, u] + dlogits[t, rows] @ ct_w[u].t()
                dg2[:, cols], dc2c[:, u] = adjoint(g2s[t, rows][:, cols], dh, dc2c[:, u],
                                                   c2s[t, rows][:, u], prev(c2s)[:, u])
                tot2 = tot2 + dg2[:, cols] @ wt2[cols]
            dh2c, dh1 = tot2[:, H:], dh1c + tot2[:, :H] + pending
            tot1 = 0.0
            for c in range(C):  # (2) cell 1
                cols, u = own_cols(c, H), slice(c * UNITS, (c + 1) * UNITS)
                dg1[:, cols], dc1c[:, u] = adjoint(g1s[t, rows][:, cols], dh1[:, u], dc1c[:, u],
                                                   c1s[t, rows][:, u], prev(c1s)[:, u])
                tot1 = tot1 + dg1[:, cols] @ wt1[cols]
            demb, dctx, dh1c = tot1[:, :H], tot1[:, H:H + F], tot1[:, H + F:]
            da = daext[t, rows] + sum(  # (3) all-reduced over the CTAs' context columns
                torch.einsum("rsf,rf->rs", enc_h[rows][:, :, c * Fc:(c + 1) * Fc],
                             dctx[:, c * Fc:(c + 1) * Fc]) for c in range(C))
            ada = a[t, rows] * da
            de = ada - a[t, rows] * ada.sum(-1, keepdim=True)  # (4)
            dqp = torch.empty(R, M)
            pending = 0.0
            for c in range(C):  # the query columns of CTA c, and (5) their phi^T partials
                m = slice(c * Mc, (c + 1) * Mc)
                q = torch.tanh(prev(h1s) @ phi[:, m])
                dqp[:, m] = torch.einsum("rs,rsm->rm", de, comp_h[rows][:, :, m]) * (1 - q * q)
                pending = pending + dqp[:, m] @ phi[:, m].t()
            for o, v in zip(outs, (dg1, dg2, de, dqp, demb)):
                o[t, rows[real]] = v[real]
    return tuple(outs)


def _inputs(rng, tf, B=6, S=11, L=7):
    torch.manual_seed(0)
    model = las.LAS(las.ASRConfig(**SIZES)).eval()
    with torch.no_grad():  # biases of both kinds, so that b = b_ih + b_hh is exercised
        for p in model.parameters():
            p.add_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) * 0.05)
    F, H = model.cfg.enc_out_dim, model.cfg.decoder_state_size
    enc_h = torch.from_numpy(rng.standard_normal((B, S, F)).astype(np.float32))
    enc_lens = torch.from_numpy(np.asarray([S, S - 3, 1, 0, S - 1, 5][:B], np.int32))
    tf_draws = torch.from_numpy((rng.random(L) < tf).astype(np.float32))
    if tf < 1:
        tf_draws[1], tf_draws[2] = 0.0, 1.0  # both kinds of feedback
    gumbel = torch.from_numpy(rng.gumbel(size=(L, B, VOCAB_SIZE)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, VOCAB_SIZE, (L, B)))
    with torch.no_grad():
        comp_h = las.attention_precompute(model.attention, enc_h)
        temb = model.embed.weight[ids]
    return model, (enc_h, comp_h, enc_lens, tf_draws, gumbel, temb), H


@pytest.mark.parametrize("R", [4, 5])
@pytest.mark.parametrize("tf", [1.0, 0.9])
def test_cluster_decomposition_equals_the_plain_forward(rng, tf, R):
    model, args, H = _inputs(rng, tf)
    assert H // UNITS == 2
    with torch.no_grad():
        want = kspell.spell_fwd_plain(model, *args, with_gates=True)
        got = fwd_model(model, *args, R)
    names = ("logits", "a", "h1s", "c1s", "h2s", "c2s", "fed", "g1s", "g2s")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("R", [4, 5])
@pytest.mark.parametrize("tf", [1.0, 0.9])
def test_cluster_decomposition_equals_the_plain_backward(rng, tf, R):
    model, args, H = _inputs(rng, tf)
    enc_h, comp_h = args[:2]
    L, B, S = args[4].shape[0], enc_h.shape[0], enc_h.shape[1]
    with torch.no_grad():
        out = kspell.spell_fwd_plain(model, *args, with_gates=True)
        streams, gates = out[1:7], out[7:]
        W = [w.detach() for w in speller_weights(model)]
        dlogits = torch.from_numpy(rng.standard_normal((L, B, VOCAB_SIZE)).astype(np.float32))
        daext = torch.from_numpy(rng.standard_normal((L, B, S)).astype(np.float32))
        want = kspell.spell_bwd_plain(enc_h, comp_h, dlogits, daext, streams, W)
        got = bwd_model(enc_h, comp_h, dlogits, daext, streams, gates, W, R)
    for name, g, w in zip(("dg1", "dg2", "de", "dqp", "demb"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=TOL, err_msg=name)


# --- the backward from the forward's stored gates ---------------------------

@pytest.mark.parametrize("tf", [1.0, 0.9])
def test_backward_from_stored_gates_matches_recompute_and_the_pallas_kernel(rng, tf):
    """spell_bwd (on the CPU: spell_bwd_plain) from the gates the forward
    wrote equals the path that recomputes them and the TPU kernel
    ``_bwd_kernel`` (interpret mode), which recomputes them too."""
    model, args, H = _inputs(rng, tf, B=4, S=9, L=10)
    enc_h, comp_h, enc_lens = args[:3]
    L, B, S = args[4].shape[0], enc_h.shape[0], enc_h.shape[1]
    with torch.no_grad():
        out = kspell.spell_fwd(model, *args, with_gates=True)
        assert len(out) == 9
        streams, gates = out[1:7], out[7:]
        W = [w.detach() for w in speller_weights(model)]
        dlogits = torch.from_numpy(rng.standard_normal((L, B, VOCAB_SIZE)).astype(np.float32))
        daext = torch.from_numpy(rng.standard_normal((L, B, S)).astype(np.float32))
        stored = kspell.spell_bwd(enc_h, comp_h, dlogits, daext, streams, W, gates)
        recomputed = kspell.spell_bwd(enc_h, comp_h, dlogits, daext, streams, W)
        shifted = kspell.shifted(streams, W[9])
    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    jstreams = tuple(j(s) for s in streams[:5]) + tuple(j(s) for s in shifted)
    lens2d = jnp.maximum(j(enc_lens), 1).reshape(-1, 1)
    pallas = jspell._run_bwd(j(enc_h), j(comp_h), lens2d, j(dlogits), j(daext), jstreams,
                             tuple(j(w) for w in W), True)
    for name, s, r, p in zip(("dg1", "dg2", "de", "dqp", "demb"), stored, recomputed, pallas):
        np.testing.assert_allclose(s.numpy(), r.numpy(), rtol=0, atol=TOL, err_msg=name)
        np.testing.assert_allclose(s.numpy(), np.asarray(p), rtol=0, atol=TOL, err_msg=name)


def test_stored_gates_are_the_cells_pre_activations(rng):
    """The gates spell_fwd writes are b + x @ W_ih + h_prev @ W_hh of each
    cell, with x = [fed | context] for cell 1 and h1_t for cell 2."""
    model, args, H = _inputs(rng, 0.9)
    with torch.no_grad():
        out = kspell.spell_fwd(model, *args, with_gates=True)
        assert len(kspell.spell_fwd(model, *args)) == 7
        a, h1s, _, h2s, _, fed = out[1:7]
        phi, wih1, whh1, b1, wih2, whh2, b2, *_ , emb = speller_weights(model)
        h1p, _, h2p, _, fedp = kspell.shifted(out[1:7], emb)
        ctx = torch.einsum("lbs,bsf->lbf", a, args[0])
        g1 = torch.cat([fedp, ctx], -1) @ wih1 + h1p @ whh1 + b1
        g2 = h1s @ wih2 + h2p @ whh2 + b2
    np.testing.assert_allclose(out[7].numpy(), g1.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(out[8].numpy(), g2.numpy(), rtol=0, atol=TOL)


def test_spell_bwd_checks_the_gates_shape(rng):
    model, args, H = _inputs(rng, 1.0, B=2, S=5, L=3)
    with torch.no_grad():
        out = kspell.spell_fwd(model, *args, with_gates=True)
        W = [w.detach() for w in speller_weights(model)]
        dl = torch.zeros(3, 2, VOCAB_SIZE)
        da = torch.zeros(3, 2, 5)
        with pytest.raises(ValueError, match="gates"):
            kspell.spell_bwd(args[0], args[1], dl, da, out[1:7], W, (out[7], out[8][:2]))
