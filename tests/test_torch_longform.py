"""The port's long-form and streaming decodes against the JAX package.

Frames of the chunked ``StreamingFrontend`` must agree with JAX's within the
frontend tolerance of ``tests/test_torch_frontend.py`` (1e-4 in the log-mel
domain above a floor 60 dB under each frame's peak); transcripts of
``transcribe_long`` (fixed windows and ``vad="energy"``),
``transcribe_stream`` and ``StreamingTranscriber`` must be equal, on one
tiny checkpoint written by the JAX package, with and without beam + LM.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_frontend import assert_logmel_close

from ss_asr_tpu import api as japi
from ss_asr_tpu import streaming as jstreaming
from ss_asr_tpu.models import charlm as jcharlm
from ss_asr_tpu.models import las as jlas
from ss_asr_tpu.ops import frontend as jfe
from ss_asr_tpu.utils import checkpoint as jckpt
from ss_asr_tpu_torch import api, streaming
from ss_asr_tpu_torch.ops import frontend as fe

torch.set_num_threads(1)

MDL = dict(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=40)
SR = 8000


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    asr, lm = str(d / "asr.npz"), str(d / "char_lm.npz")
    jckpt.save_pytree(asr, jax.tree.map(np.asarray, jlas.init_asr(
        jax.random.key(0), jlas.ASRConfig(**MDL))))
    jckpt.save_pytree(lm, jax.tree.map(np.asarray, jcharlm.init_charlm(
        jax.random.key(1), jcharlm.CharLMConfig(hidden_size=8))))
    return asr, lm


def _pair(ckpts, beam_lm=False):
    asr, lm = ckpts
    config = {"asr": {"mdl": MDL, "decode_beam_size": 3 if beam_lm else 1,
                      "decode_lm_weight": 0.5}, "char_lm": {"mdl": {"hidden_size": 8}}}
    kw = dict(max_steps=8, sr=SR, t_bucket=16, lm_path=lm if beam_lm else None)
    return (japi.Transcriber.from_checkpoint(asr, config, use_pallas_kernel=False, **kw),
            api.Transcriber.from_checkpoint(asr, config, device="cpu", **kw))


def _speech_like(rng, seconds, pauses=()):
    """Noise bursts with near-silent pauses (start, end in seconds)."""
    y = 0.3 * rng.standard_normal(int(seconds * SR)).astype(np.float32)
    for a, b in pauses:
        y[int(a * SR) : int(b * SR)] *= 0.01
    return y


def _chunks(y, sizes):
    out, i, k = [], 0, 0
    while i < len(y):
        n = sizes[k % len(sizes)]
        out.append(y[i : i + n])
        i, k = i + n, k + 1
    return out


@pytest.mark.parametrize("n,sizes", [(12345, (1000,)), (20000, (37, 4096, 900)), (50, (7,)),
                                     (0, (5,))], ids=["even", "ragged", "short", "empty"])
def test_streaming_frontend_matches_jax(rng, n, sizes):
    y = (0.3 * rng.standard_normal(n)).astype(np.float32)
    outs = []
    for mod, kw in ((jfe, {}), (fe, {"device": "cpu"})):
        f = mod.StreamingFrontend(SR, block=4000, **kw)
        parts = [np.asarray(f.push(c)) for c in _chunks(y, sizes)] + [np.asarray(f.close())]
        outs.append(np.concatenate(parts, 0))
    got, want = outs[1], outs[0]
    assert got.shape == want.shape
    if n:
        assert_logmel_close(got, want)
        # and equal to the one-shot frontend of the whole signal
        assert_logmel_close(got, fe.compute_fbank(y, SR, device="cpu"))


@pytest.mark.parametrize("vad", [None, "energy"], ids=["windows", "vad"])
@pytest.mark.parametrize("beam_lm", [False, True], ids=["greedy", "beam3+lm"])
def test_transcribe_long_matches_jax(ckpts, rng, vad, beam_lm):
    jt, pt = _pair(ckpts, beam_lm)
    y = _speech_like(rng, 5.3, pauses=[(1.4, 1.7), (3.1, 3.3)])
    kw = dict(window_s=2.0, overlap_s=0.5, vad=vad)
    want = jt.transcribe_long(y, SR, **kw)
    assert pt.transcribe_long(y, SR, **kw) == want
    # one window: the plain path; nothing: ""
    assert pt.transcribe_long(y[: SR], SR, **kw) == pt.transcribe_signal(y[: SR], SR)
    assert pt.transcribe_long(np.zeros(0, np.float32), SR) == ""
    with pytest.raises(ValueError, match="vad must be"):
        pt.transcribe_long(y, SR, vad="webrtc")


@pytest.mark.parametrize("beam_lm", [False, True], ids=["greedy", "beam3+lm"])
def test_streaming_transcriber_matches_jax(ckpts, rng, beam_lm):
    jt, pt = _pair(ckpts, beam_lm)
    y = _speech_like(rng, 6.0, pauses=[(2.0, 2.4), (4.1, 4.3)])
    chunks = _chunks(y, (3000, 1234))
    texts = []
    for mod, t in ((jstreaming, jt), (streaming, pt)):
        st = mod.StreamingTranscriber(t, commit_window_s=2.5, min_segment_s=0.5)
        partials = []
        for c in chunks:
            st.feed(c)
            partials.append((st.partial(), st.committed_text))
        texts.append((partials, st.finalize(), st.finalize()))
    assert texts[1] == texts[0]
    assert pt.transcribe_stream(chunks, SR) == jt.transcribe_stream(chunks, SR)


def test_short_stream_equals_the_one_shot_path(ckpts, rng):
    _, pt = _pair(ckpts)
    y = _speech_like(rng, 1.2)
    st = streaming.StreamingTranscriber(pt)
    for c in _chunks(y, (500,)):
        st.feed(c)
    assert st.finalize() == pt.transcribe_signal(y, SR)
    with pytest.raises(RuntimeError, match="after finalize"):
        st.feed(y[:10])
    with pytest.raises(ValueError, match="min_segment_s"):
        streaming.StreamingTranscriber(pt, commit_window_s=1.0, min_segment_s=2.0)
