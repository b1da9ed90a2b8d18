"""What the redesigned LSTM, beam and frontend kernels rest on, held on
the CPU: the routes that ``lstm_fwd`` and ``lstm_bwd`` take from a shape,
numpy models of their cluster routes' decompositions (column slices per
CTA; the forward's h all-gathered, the backward's carry a sum of per-CTA
partials; skipped steps) against the plain versions, the
packed DFT basis against numpy, a numpy model of the 3xTF32 split against
float64 by the frontend kernel's own tolerances, and the ``device``
argument that the frontend's entry points and the scheduled-sampling draws
now require.
"""

import numpy as np
import pytest
import torch

from chip_smoke import FBANK_LIN_TOL, FBANK_LOG_TOL, fbank_errors
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops import frontend as fe
from ss_asr_tpu_torch.ops.kernels import frontend as kfe
from ss_asr_tpu_torch.ops.kernels import lstm as klstm


@pytest.mark.parametrize("B", [1, 32, 64])
@pytest.mark.parametrize("H,C", [(8, 0), (64, 1), (128, 2), (256, 8), (384, 0), (512, 0)])
def test_lstm_bwd_route_by_shape(H, C, B):
    """The smallest cluster whose slice fits and whose CTAs own whole warps
    of units; the streaming kernel where none does.  Tiles of 4 rows while
    all of them are resident at once, else 8."""
    got_c, got_r = klstm.lstm_bwd_route(H, B, 2)
    assert got_c == C
    if C == 0:
        assert got_r == 0
        assert not any(klstm.cluster_serves(H, c) for c in klstm.CLUSTER_SIZES)
        return
    assert klstm.cluster_serves(H, C, got_r)
    assert not any(klstm.cluster_serves(H, c) for c in klstm.CLUSTER_SIZES if c < C)
    fit = [r for r in klstm.TILE_ROWS if -(-B // r) * 2 <= klstm.CARD_CLUSTERS[C]]
    assert got_r == (fit[0] if fit else 8)
    # the flagship: the card holds 15 clusters of 8, so B = 32 (16 tiles of 4 rows in two
    # directions, one too many) takes tiles of 5 rows: 14 clusters, one wave
    if H == 256:
        assert got_r == {1: 4, 32: 5, 64: 8}[B]


@pytest.mark.parametrize("H,C,R", [(256, 8, 8), (256, 8, 4), (128, 2, 8), (128, 4, 4), (64, 1, 8),
                                   (64, 2, 4), (64, 2, 8)])
def test_cluster_shared_memory_fits_and_holds_the_slice(H, C, R):
    nbytes = klstm.cluster_smem_bytes(H, C, R)
    slice_bytes = 4 * H * (4 * H // C)  # the resident columns of W_hh, unpadded
    assert slice_bytes < nbytes <= klstm.SMEM_BYTES
    assert klstm.cluster_serves(H, C, R)
    # at the flagship no smaller cluster holds the slice
    if H == 256:
        assert not any(klstm.cluster_serves(H, c, R) for c in (1, 2, 4))


def test_cluster_refuses_what_it_does_not_serve():
    assert not klstm.cluster_serves(256, 4)      # 256 KB slice
    assert not klstm.cluster_serves(384, 8)      # 48 units a CTA: no whole warps
    assert not klstm.cluster_serves(256, 3)
    assert not klstm.cluster_serves(256, 8, 7)
    assert not klstm.cluster_serves(8, 1)
    assert not klstm.cluster_serves(32, 1)       # the carry product wants H in 64s


def cluster_model(gx, whh, lengths, y, cs, dy, reverse, C, R):
    """numpy model of the cluster route for one direction: per tile of R rows,
    CTA c owns units [c*Hc, (c+1)*Hc) and the columns q*H + c*Hc + j of W_hh;
    the gates of its units come from all of h_p and its column slice, the
    carry dh' of every unit is the sum over the CTAs of dgates[own columns] @
    W[:, own columns]^T (zero, not held, for a row past its length), dc stays
    local, and the steps on which no row of the tile is inside its length
    are skipped with dgx = 0."""
    T, B, G = gx.shape
    H, Hc = G // 4, G // 4 // C
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    dgx = np.full_like(gx, np.nan)
    for b0 in range(0, B, R):
        rows = slice(b0, min(b0 + R, B))
        lens = np.clip(lengths[rows], 0, T)
        maxlen = int(lens.max())
        steps = range(0, maxlen) if reverse else range(T - maxlen, T)
        for s in range(T):
            if s not in steps:
                dgx[s if reverse else T - 1 - s, rows] = 0.0
        cols = [np.concatenate([np.arange(q * H + c * Hc, q * H + (c + 1) * Hc) for q in range(4)])
                for c in range(C)]
        dh_c = np.zeros((lens.size, H), gx.dtype)
        dc_c = np.zeros((lens.size, H), gx.dtype)
        for s in steps:
            t = s if reverse else T - 1 - s
            tp = t + 1 if reverse else t - 1
            has_p = 0 <= tp < T
            h_p = y[tp, rows] if has_p else np.zeros_like(dh_c)
            c_p = cs[tp, rows] if has_p else np.zeros_like(dh_c)
            valid = (t < lens)[:, None]
            partial = np.zeros((C,) + dh_c.shape, gx.dtype)
            for c in range(C):
                own = slice(c * Hc, (c + 1) * Hc)
                a = gx[t, rows][:, cols[c]] + h_p @ whh[:, cols[c]]
                i, f, g, o = sig(a[:, :Hc]), sig(a[:, Hc:2 * Hc]), np.tanh(a[:, 2 * Hc:3 * Hc]), \
                    sig(a[:, 3 * Hc:])
                tanh_c = np.tanh(cs[t, rows][:, own])
                dh = dh_c[:, own] + dy[t, rows][:, own]
                dct = dh * o * (1 - tanh_c * tanh_c) + dc_c[:, own]
                dg = np.concatenate([dct * g * i * (1 - i), dct * c_p[:, own] * f * (1 - f),
                                     dct * i * (1 - g * g), dh * tanh_c * o * (1 - o)], -1)
                dg = np.where(valid, dg, 0.0)
                dc_c[:, own] = np.where(valid, dct * f, dc_c[:, own])
                dgx[t, rows.start:rows.stop, cols[c]] = dg.T
                partial[c] = dg @ whh[:, cols[c]].T
            dh_c = partial.sum(0)
    return dgx


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("C,R", [(1, 8), (2, 4), (4, 8)])
def test_cluster_decomposition_equals_the_plain_backward(rng, reverse, C, R):
    """In float64, so that only the algebra is held: the slices, the
    reduce-scatter, the zeroed (not held) carry past a length and the skipped
    steps give lstm_bwd_plain's dgx."""
    T, B, H = 9, 11, 8 * C
    gx = rng.standard_normal((T, B, 4 * H))
    whh = rng.standard_normal((H, 4 * H)) / np.sqrt(H)
    dy = rng.standard_normal((T, B, H))
    lens = rng.integers(0, T + 1, size=B)
    lens[:3] = (0, 1, T)
    lens[8:] = (2, 3, 0)  # the last tile of 8 rows (and of 4) ends early
    tgx, twhh, tdy = (torch.from_numpy(a) for a in (gx, whh, dy))
    tl = torch.from_numpy(lens)
    y, cs = klstm.lstm_seq_plain(tgx, twhh, tl, reverse)
    want = klstm.lstm_bwd_plain(tgx, twhh, tl, y, cs, tdy, reverse).numpy()
    got = cluster_model(gx, whh, lens, y.numpy(), cs.numpy(), dy, reverse, C, R)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("B", [1, 8, 16, 32, 64])
@pytest.mark.parametrize("H,C", [(8, 0), (64, 1), (128, 2), (256, 8), (320, 0), (384, 0),
                                 (512, 0)])
def test_lstm_fwd_route_by_shape(H, C, B):
    """The forward's route: the smallest cluster whose slice fits its own
    shared-memory plan at tiles of 8 rows; tiles of 4 rows while all clusters
    are resident at once, else the smallest that are; the streaming kernel
    where no cluster serves."""
    got_c, got_r = klstm.lstm_fwd_route(H, B, 2)
    assert got_c == C
    if C == 0:
        assert got_r == 0
        assert not any(klstm.fwd_cluster_serves(H, c) for c in klstm.CLUSTER_SIZES)
        return
    assert klstm.fwd_cluster_serves(H, C, got_r)
    assert not any(klstm.fwd_cluster_serves(H, c) for c in klstm.CLUSTER_SIZES if c < C)
    fit = [r for r in klstm.TILE_ROWS if -(-B // r) * 2 <= klstm.CARD_CLUSTERS[C]]
    assert got_r == (fit[0] if fit else 8)
    # the flagship's batches: serving (8, 16), training (32: 14 clusters of 8 where 15
    # fit), the TAE (64: 16 clusters, a second wave)
    if H == 256:
        assert got_r == {1: 4, 8: 4, 16: 4, 32: 5, 64: 8}[B]


@pytest.mark.parametrize("H,C,R", [(256, 8, 8), (256, 8, 4), (128, 2, 8), (128, 4, 4), (64, 1, 8),
                                   (64, 2, 5), (128, 4, 6)])
def test_fwd_cluster_shared_memory_holds_the_slice_and_its_buffers(H, C, R):
    Hc, LC = H // C, 4 * H // C
    want = 4 * (H * LC + 2 * R * H + 3 * R * LC + 8 * R * LC + R * Hc + R)
    assert klstm.fwd_cluster_smem_bytes(H, C, R) == want
    assert 4 * H * LC < want <= klstm.SMEM_BYTES
    assert klstm.fwd_cluster_serves(H, C, R)
    if H == 256:  # no smaller cluster holds the flagship's slice
        assert not any(klstm.fwd_cluster_serves(H, c, R) for c in (1, 2, 4))


def test_fwd_cluster_refuses_what_it_does_not_serve():
    assert not klstm.fwd_cluster_serves(256, 4)   # a 256 KB slice
    assert not klstm.fwd_cluster_serves(384, 8)   # 48 units a CTA: no whole warps
    assert not klstm.fwd_cluster_serves(256, 3)
    assert not klstm.fwd_cluster_serves(256, 8, 7)
    assert not klstm.fwd_cluster_serves(32, 1)    # 16 k-slices of float4s want H in 64s
    assert not klstm.fwd_cluster_serves(128, 1)   # 128 units, but a 256 KB slice


def fwd_cluster_model(gx, whh, lengths, reverse, C, R, slices=16):
    """numpy model of the forward's cluster route for one direction: per tile
    of R rows, CTA c owns units [c*Hc, (c+1)*Hc) and the columns q*H + c*Hc
    + j of W_hh; its gate sums come from all of the gathered h in ``slices``
    k-slices whose pairs meet first; it updates its units' cells and writes
    its piece of h_t into every CTA's copy of the next step's h (an
    all-gather: afterwards every copy is the whole h_t); the steps that no
    row of the tile reaches are skipped and written after the loop."""
    T, B, G = gx.shape
    H, Hc = G // 4, G // 4 // C
    KS = H // slices
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    y = np.full((T, B, H), np.nan)
    cs = np.full((T, B, H), np.nan)
    cols = [np.concatenate([np.arange(q * H + c * Hc, q * H + (c + 1) * Hc) for q in range(4)])
            for c in range(C)]
    for b0 in range(0, B, R):
        rows = slice(b0, min(b0 + R, B))
        lens = np.clip(lengths[rows], 0, T)
        maxlen = int(lens.max())
        copies = np.zeros((C, 2, lens.size, H))  # every CTA's double-buffered h
        cc = np.zeros((lens.size, H))
        steps = range(T - maxlen, T) if reverse else range(maxlen)
        for n, s in enumerate(steps):
            t = T - 1 - s if reverse else s
            buf = n & 1
            valid = (t < lens)[:, None]
            for c in range(C):
                own = slice(c * Hc, (c + 1) * Hc)
                h = copies[c, buf]
                part = [h[:, k * KS:(k + 1) * KS] @ whh[k * KS:(k + 1) * KS][:, cols[c]]
                        for k in range(slices)]
                pairs = [part[2 * p] + part[2 * p + 1] for p in range(slices // 2)]
                a = gx[t, rows][:, cols[c]] + sum(pairs[0::2]) + sum(pairs[1::2])
                i, f, g, o = sig(a[:, :Hc]), sig(a[:, Hc:2 * Hc]), np.tanh(a[:, 2 * Hc:3 * Hc]), \
                    sig(a[:, 3 * Hc:])
                c_new = f * cc[:, own] + i * g
                h_new = o * np.tanh(c_new)
                cc[:, own] = np.where(valid, c_new, cc[:, own])
                y[t, rows, own] = np.where(valid, h_new, 0.0)
                cs[t, rows, own] = cc[:, own]
                for dst in range(C):  # the all-gather
                    copies[dst, buf ^ 1][:, own] = np.where(valid, h_new, h[:, own])
        for t in range(maxlen, T):
            y[t, rows] = 0.0
            cs[t, rows] = 0.0 if reverse else cc
    return y, cs


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("C,R", [(1, 8), (2, 4), (4, 5), (8, 8)])
def test_fwd_cluster_decomposition_equals_the_plain_forward(rng, reverse, C, R):
    """In float64, so that only the algebra is held: the column slices, the
    k-slices and their pairs, the all-gather into double-buffered copies, the
    frozen carry past a length and the skipped steps give lstm_seq_plain."""
    T, B, H = 9, 11, 16 * C
    gx = rng.standard_normal((T, B, 4 * H))
    whh = rng.standard_normal((H, 4 * H)) / np.sqrt(H)
    lens = rng.integers(0, T + 1, size=B)
    lens[:3] = (0, 1, T)
    lens[8:] = (2, 3, 0)  # the last tile of 8 rows (and of 4) ends early
    want = klstm.lstm_seq_plain(torch.from_numpy(gx), torch.from_numpy(whh),
                                torch.from_numpy(lens), reverse)
    got = fwd_cluster_model(gx, whh, lens, reverse, C, R)
    for g, w in zip(got, want):
        assert not np.isnan(g).any()
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("K", [1, 3, 4, 5, 8, 9, 10, 11, 12, 13, 14, 15, 16])
@pytest.mark.parametrize("B", [1, 8, 16, 32])
@pytest.mark.parametrize("lm_hidden", [0, 128])
def test_beam_route_by_shape(K, B, lm_hidden):
    """K8's route at the flagship width: clusters of 8 CTAs (128 gate
    columns each) for every K, one utterance a cluster while all clusters
    are resident at once (15 of 8 CTAs), else two where the 8 rows hold them
    (K <= 4); K 9-16 take the 16-row variant, one utterance a cluster
    whatever the batch, at S = 64 and at S = 1500 (120 s); the shared-memory
    plan of the route's variant fits with at least three ring stages."""
    from ss_asr_tpu_torch.ops.kernels import beam as kbeam

    for S in (64, 1500) if K > 8 else (64,):
        C, U = kbeam.beam_route(256, 512, 128, 50, lm_hidden, S, K, B)
        assert (C, U) == (8, 1 if B <= 15 or K > 4 else 2)
        floats, att_in_smem, stages = kbeam.cluster_plan(256, 512, 128, 50, lm_hidden, S, K, C, U)
        assert floats <= kbeam.SMEM_FLOATS and att_in_smem and 3 <= stages <= kbeam.MAX_STAGES


def test_beam_cluster_plan_refuses_what_it_does_not_serve():
    from ss_asr_tpu_torch.ops.kernels import beam as kbeam

    assert kbeam.cluster_plan(256, 512, 128, 50, 128, 64, 16, 8, 2) is None   # 2 x 16 rows
    assert kbeam.cluster_plan(256, 512, 128, 50, 0, 64, 9, 8, 2) is None      # U = 2 at K > 8
    assert kbeam.cluster_plan(256, 512, 128, 50, 128, 64, 8, 8, 2) is None    # 2 x 8 rows
    assert kbeam.cluster_plan(256, 512, 128, 50, 128, 64, 3, 8, 4) is None    # 4 x 4 rows
    assert kbeam.cluster_plan(256, 512, 128, 50, 128, 64, 17, 8, 1) is None   # K = 17
    assert kbeam.cluster_plan(256, 512, 128, 12, 128, 64, 16, 8, 1) is None   # V < K
    assert kbeam.cluster_plan(256, 4096, 128, 50, 0, 64, 16, 8, 1) is None    # F / C > 128 at 16 rows
    assert kbeam.cluster_plan(256, 512, 128, 50, 128, 64, 3, 4, 1) is None    # 256 columns
    assert kbeam.cluster_plan(40, 48, 300, 50, 36, 20, 3, 1, 1) is None       # H = 40
    assert kbeam.cluster_plan(256, 512, 128, 50, 256, 64, 3, 8, 1) is None    # 6 HL / C > 128
    assert kbeam.cluster_plan(256, 512, 128, 50, 128, 64, 3, 16, 1) is None      # 64 columns
    # the attention weights stay in shared memory to S = 1500 (120 s) and on to 10,000
    # steps, past that in the global scratch, whose size the wrapper derives from the plan
    plans = [kbeam.cluster_plan(256, 512, 128, 50, 128, S, 3, 8, 2) for S in (64, 1500, 16000)]
    assert [p[1] for p in plans] == [True, True, False] and all(p[2] >= 3 for p in plans)
    # at 16 rows to 1500 steps, past that in the global scratch
    plans = [kbeam.cluster_plan(256, 512, 128, 50, 128, S, 16, 8, 1) for S in (64, 1500, 8000)]
    assert [p[1] for p in plans] == [True, True, False] and all(p[2] >= 3 for p in plans)


@pytest.mark.parametrize("use_lm", [False, True], ids=["beam", "beam+lm"])
def test_beam_weight_stream_is_packed_once_per_weights(use_lm):
    """K8's packed weight panels are reused while the weights stay as they
    were, equal to a fresh packing; an in-place change (an optimizer step,
    ``load_state_dict``), another LM or a new model repacks them."""
    import copy

    from ss_asr_tpu_torch.models import charlm
    from ss_asr_tpu_torch.ops.kernels import beam as kbeam
    from ss_asr_tpu_torch.ops.kernels.decode import lm_operands, speller_operands

    torch.manual_seed(0)
    model = las.LAS(las.ASRConfig(encoder_state_size=32, decoder_state_size=64, mlp_out_size=32,
                                  feature_dim=5))
    lm = charlm.CharLM(charlm.CharLMConfig(hidden_size=32)) if use_lm else None
    cpu = torch.device("cpu")

    def packed(model, lm):
        ws = speller_operands(model, cpu)
        lws = lm_operands(lm, cpu) if lm is not None else None
        return kbeam.cached_weight_stream(model, lm, ws, lws, 2), kbeam.weight_stream(ws, lws, 2)

    first, fresh = packed(model, lm)
    assert torch.equal(first, fresh)
    assert packed(model, lm)[0] is first
    with torch.no_grad():
        model.decoder.layer_2.weight_hh.add_(1.0)
    second, fresh = packed(model, lm)
    assert second is not first and torch.equal(second, fresh)
    other = copy.deepcopy(model)
    assert packed(other, lm)[0] is not second and packed(model, lm)[0] is second
    if use_lm:
        lm.load_state_dict(lm.state_dict())
        third, fresh = packed(model, lm)
        assert third is not second and torch.equal(third, fresh)
        new_lm = copy.deepcopy(lm)
        assert packed(model, new_lm)[0] is not third


@pytest.mark.parametrize("sr", [8000, 16000, 22050])
def test_packed_basis_against_numpy(sr):
    n_fft, _ = fe.frame_params(sr)
    wb = fe._windowed_dft_basis(n_fft)
    n_bins = wb.shape[1] // 2
    il = kfe.interleave_basis(torch.from_numpy(wb)).numpy()
    kpad = -(-n_fft // 8) * 8
    ncols = -(-2 * n_bins // 96) * 96
    assert il.shape == (kpad, ncols) and (kfe.K_STEP, kfe.COL_CHUNK) == (8, 96)
    want = np.zeros((kpad, ncols), np.float32)
    want[:n_fft, 0:2 * n_bins:2] = wb[:, :n_bins]
    want[:n_fft, 1:2 * n_bins:2] = wb[:, n_bins:]
    np.testing.assert_array_equal(il, want)
    # a frame extended by any finite samples up to the padded K gives the same spectrum
    x = np.random.default_rng(sr).standard_normal(kpad).astype(np.float32)
    spec = x @ il
    np.testing.assert_allclose(spec[0:2 * n_bins:2], x[:n_fft] @ wb[:, :n_bins], atol=1e-4)
    np.testing.assert_allclose(spec[1:2 * n_bins:2], x[:n_fft] @ wb[:, n_bins:], atol=1e-4)
    assert not spec[2 * n_bins:].any()


def tf32(x):
    """float32 -> the nearest value with 10 explicit mantissa bits, ties away
    from zero (``cvt.rna.tf32.f32``), still stored as float32."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def test_tf32_split_model():
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -3.14159274, 1e-20, 0.0], np.float32)
    hi, lo = split(x)
    np.testing.assert_array_equal(hi[:3], [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10])
    assert (hi.view(np.uint32) & 0x1FFF == 0).all() and (lo.view(np.uint32) & 0x1FFF == 0).all()
    # what the two halves leave out is below 2^-21 of the value
    assert (np.abs(x.astype(np.float64) - hi - lo) <= np.abs(x) * 2.0 ** -21).all()


@pytest.mark.parametrize("sr", [16000, 22050])
def test_three_term_tf32_product_meets_the_frontend_tolerances(sr):
    """The smoke's signals (three tones in noise, a ragged batch) through a
    numpy model of the kernel's DFT product (a_lo b_hi + a_hi b_lo + a_hi
    b_hi, each a float32 product of TF32 operands, summed in float32)
    against the float64 frontend, by K11's rule: 1e-4 in the log domain
    within 60 dB of the frame's peak, 1e-5 of the row's largest energy in
    the linear domain.  One TF32 term alone misses it."""
    rng = np.random.default_rng(sr)
    n_fft, hop = fe.frame_params(sr)
    lens = np.array([40 * hop + 1, 25 * hop + 7, 1, 33 * hop])
    buf = np.zeros((len(lens), int(lens.max())), np.float32)
    for i, k in enumerate(lens):
        t = np.arange(k) / sr
        buf[i, :k] = sum(0.2 * np.sin(2 * np.pi * f * t) for f in rng.uniform(100, 3000, 3))
        buf[i, :k] += 0.05 * rng.standard_normal(k)
    yp = fe.reflect_padded(torch.from_numpy(buf), torch.from_numpy(lens), n_fft // 2)
    nf = int(fe.num_frames(buf.shape[1], n_fft, hop))
    wbasis, mel, _ = fe._projections(sr, 40, 25, 10, torch.device("cpu"))
    want = kfe.fbank_plain(yp.double(), wbasis.double(), mel.double(), nf, n_fft, hop)

    il = kfe.interleave_basis(wbasis).numpy()
    kpad, n_bins = il.shape[0], mel.shape[0]
    ypz = np.concatenate([yp.numpy(), np.zeros((len(lens), kpad), np.float32)], 1)
    frames = np.stack([ypz[:, f * hop: f * hop + kpad] for f in range(nf)], 1)  # [B, nf, kpad]
    a_hi, a_lo = split(frames)
    b_hi, b_lo = split(il)

    def log_mel(spec):
        power = spec[..., 0:2 * n_bins:2] ** 2 + spec[..., 1:2 * n_bins:2] ** 2
        return torch.from_numpy(np.log(power @ mel.numpy() + np.float32(kfe.LOG_EPS)))

    three = (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
    assert three.dtype == np.float32
    log_err, lin_err = fbank_errors(torch, log_mel(three), want.float())
    assert log_err <= FBANK_LOG_TOL and lin_err <= FBANK_LIN_TOL, (log_err, lin_err)
    one_log, one_lin = fbank_errors(torch, log_mel(a_hi @ b_hi), want.float())
    assert one_log > FBANK_LOG_TOL, (one_log, one_lin)


def test_frontend_entry_points_require_a_device():
    y = np.zeros(400, np.float32)
    with pytest.raises(TypeError, match="device"):
        fe.compute_fbank(y, 8000)
    with pytest.raises(TypeError, match="device"):
        fe.StreamingFrontend(8000)
    with pytest.raises(TypeError, match="device"):
        fe.log_mel_fbank_ragged([y], 8000)
    with pytest.raises(TypeError):  # positional no longer
        fe.compute_fbank(y, 8000, 40, "cpu")
    assert fe.compute_fbank(y, 8000, device="cpu").shape == (6, 40)
    assert fe.StreamingFrontend(8000, device="cpu").device.type == "cpu"
    assert len(fe.log_mel_fbank_ragged([y], 8000, device="cpu")) == 1


def test_scheduled_sampling_draws_require_a_device():
    cfg = las.ASRConfig(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=5)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(TypeError, match="device"):
        las.draw_scheduled_sampling(4, 2, 0.5, cfg, g)
    with pytest.raises(TypeError):
        las.draw_scheduled_sampling(4, 2, 0.5, cfg, g, "cpu")
    tf_draws, gumbel = las.draw_scheduled_sampling(4, 2, 0.5, cfg, g, device="cpu")
    assert tf_draws.shape == (4,) and gumbel.shape == (4, 2, cfg.vocab_size)
