"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips.  On a machine
with one (which need not have JAX; the repository's conftest imports it, so
skip it there)::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py

The shapes are small and deliberately ragged (hidden sizes that are not a
multiple of the block, batches that are not a multiple of the row tile,
lengths 0 and 1), where ``chip_smoke.py`` checks the flagship shapes.
"""

import copy

import numpy as np
import pytest
import torch

from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.api import Transcriber
from ss_asr_tpu_torch.models import charlm, las
from ss_asr_tpu_torch.ops import frontend
from ss_asr_tpu_torch.ops.kernels import decode as kdec
from ss_asr_tpu_torch.ops.kernels import lstm as klstm
from ss_asr_tpu_torch.vocab import EOS_ID

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _models(cfg, lm_hidden, seed, device):
    model = las.LAS(cfg)
    model.load_state_dict(convert.asr_state_from_params(convert.init_asr_numpy(seed, cfg)))
    lcfg = charlm.CharLMConfig(hidden_size=lm_hidden)
    lm = charlm.CharLM(lcfg)
    lm.load_state_dict(convert.charlm_state_from_params(convert.init_charlm_numpy(seed + 1, lcfg)))
    return model.to(device).eval(), lm.to(device).eval()


@pytest.mark.parametrize("D,reverse", [(1, (False,)), (1, (True,)), (2, (False, True))])
@pytest.mark.parametrize("T,B,H", [(13, 5, 40), (1, 1, 8), (7, 17, 300)])
def test_lstm_fwd_matches_plain(cuda, D, reverse, T, B, H):
    rng = np.random.default_rng(T * B + H)
    gx = torch.from_numpy(rng.standard_normal((D, T, B, 4 * H)).astype(np.float32)).to(cuda)
    whh = torch.from_numpy((rng.standard_normal((D, H, 4 * H)) / np.sqrt(H)).astype(np.float32))
    whh = whh.to(cuda)
    lens = rng.integers(0, T + 1, size=B)
    lens[: min(B, 2)] = (0, 1)[: min(B, 2)]
    lengths = torch.from_numpy(lens.astype(np.int32)).to(cuda)
    before = klstm.LAUNCHES["lstm_fwd"]
    y, cs = klstm.lstm_fwd(gx, whh, lengths, reverse)
    torch.cuda.synchronize()
    assert klstm.LAUNCHES["lstm_fwd"] == before + 1
    for d in range(D):
        y_ref, cs_ref = klstm.lstm_seq_plain(gx[d], whh[d], lengths, reverse[d])
        torch.testing.assert_close(y[d], y_ref, atol=1e-5, rtol=0)
        torch.testing.assert_close(cs[d], cs_ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("sizes,lm_hidden", [
    (dict(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=5), 8),
    (dict(encoder_state_size=24, decoder_state_size=40, mlp_out_size=300, feature_dim=7), 36),
])
@pytest.mark.parametrize("use_lm", [False, True], ids=["greedy", "greedy+lm"])
def test_greedy_decode_matches_plain(cuda, sizes, lm_hidden, use_lm):
    cfg = las.ASRConfig(**sizes)
    model, lm = _models(cfg, lm_hidden, 3, cuda)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((6, 40, cfg.feature_dim)).astype(np.float32)).to(cuda)
    x_lens = torch.tensor([40, 33, 9, 3, 17, 40], dtype=torch.int32, device=cuda)
    lm_ = lm if use_lm else None
    with torch.inference_mode():
        enc_h, enc_lens = las.listener_apply(model.encoder, x, x_lens)
        comp_h = las.attention_precompute(model.attention, enc_h)
        got = kdec.greedy_decode(model, enc_h, comp_h, enc_lens, 30, lm_, 0.6)
        want = kdec.greedy_decode_plain(model, enc_h, comp_h, enc_lens, 30, lm_, 0.6)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_greedy_decode_early_exit(cuda):
    cfg = las.ASRConfig(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=5)
    model, _ = _models(cfg, 8, 4, cuda)
    model = copy.deepcopy(model)
    with torch.no_grad():
        model.char_trans.bias[EOS_ID] = 50.0
    x = torch.randn(3, 16, 5, device=cuda)
    with torch.inference_mode():
        enc_h, enc_lens = las.listener_apply(model.encoder, x,
                                             torch.tensor([16, 5, 0], device=cuda))
        comp_h = las.attention_precompute(model.attention, enc_h)
        got = kdec.greedy_decode(model, enc_h, comp_h, enc_lens, 9).cpu()
    assert (got[:, 0] == EOS_ID).all() and (got[:, 1:] == 0).all()


def test_frontend_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(0)
    buf = (0.3 * rng.standard_normal((3, 11025))).astype(np.float32)
    lens = torch.tensor([11025, 100, 1])
    want, wl = frontend.log_mel_fbank_batch(torch.from_numpy(buf), lens, 22050)
    got, gl = frontend.log_mel_fbank_batch(torch.from_numpy(buf).to(cuda), lens.to(cuda), 22050)
    assert torch.equal(gl.cpu(), wl)
    torch.testing.assert_close(got[0].cpu(), want[0], atol=1e-4, rtol=0)


def test_transcriber_on_the_card_matches_the_cpu(cuda):
    cfg = las.ASRConfig(encoder_state_size=16, decoder_state_size=16, mlp_out_size=8)
    rng = np.random.default_rng(1)
    sigs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (3000, 0, 4500)]
    out = []
    for dev in ("cpu", cuda):
        model, lm = _models(cfg, 8, 5, dev)
        t = Transcriber(model, lm=lm, lm_weight=0.5, sr=8000, max_steps=12, t_bucket=16)
        out.append(t.transcribe_signal_batch(sigs))
    assert out[0] == out[1]
