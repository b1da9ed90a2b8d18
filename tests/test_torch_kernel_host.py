"""What the redesigned LSTM-backward and frontend kernels rest on, held on
the CPU: the route that ``lstm_bwd`` takes from a shape, a numpy model of
the cluster route's decomposition (column slices per CTA, the carry as a
sum of per-CTA partials, skipped steps) against the plain version, the
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
