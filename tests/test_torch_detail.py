"""The port's n-best, forced alignment and rescoring against the JAX package.

One tiny npz checkpoint pair written by the JAX package goes through both
packages on the CPU (the port's kernel wrappers take their plain versions
there).  Alignment frames and every text must be equal; scores and
per-character log-probs agree within 1e-4 (float32 sums of per-step
log-probs over a few dozen steps, accumulated in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss_asr_tpu import api as japi
from ss_asr_tpu.decode import align as jalign
from ss_asr_tpu.decode import rescore as jrescore
from ss_asr_tpu.models import charlm as jcharlm
from ss_asr_tpu.models import las as jlas
from ss_asr_tpu.utils import checkpoint as jckpt
from ss_asr_tpu_torch import api
from ss_asr_tpu_torch.decode import align, rescore
from ss_asr_tpu_torch.vocab import Mapper

torch.set_num_threads(1)

MDL = dict(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=40)
TOL = 1e-4


def _config(beam):
    return {"asr": {"mdl": MDL, "decode_beam_size": beam, "decode_lm_weight": 0.5},
            "char_lm": {"mdl": {"hidden_size": 8}}}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    asr, lm = str(d / "asr.npz"), str(d / "char_lm.npz")
    # this seed's n-best mixes hypotheses that end early with ones that run
    # to max_steps
    jckpt.save_pytree(asr, jax.tree.map(np.asarray, jlas.init_asr(jax.random.key(3),
                                                                  jlas.ASRConfig(**MDL))))
    jckpt.save_pytree(lm, jax.tree.map(np.asarray, jcharlm.init_charlm(
        jax.random.key(8), jcharlm.CharLMConfig(hidden_size=8))))
    return asr, lm


def _pair(ckpts, beam=1, with_lm=True):
    asr, lm = ckpts
    kw = dict(max_steps=12, sr=8000, t_bucket=16)
    lm_path = lm if with_lm else None
    jt = japi.Transcriber.from_checkpoint(asr, _config(beam), lm_path=lm_path,
                                          use_pallas_kernel=False, **kw)
    pt = api.Transcriber.from_checkpoint(asr, _config(beam), lm_path=lm_path, device="cpu", **kw)
    return jt, pt


def _fbanks(rng, lens=(40, 23, 0, 56)):
    return [rng.standard_normal((n, 40)).astype(np.float32) for n in lens]


def _assert_hyps_equal(got, want, scores=True):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert [h.text for h in g_row] == [h.text for h in w_row]
        for g, w in zip(g_row, w_row):
            np.testing.assert_array_equal(g.char_frames, w.char_frames)
            np.testing.assert_allclose(g.char_starts, w.char_starts, rtol=0, atol=1e-6)
            np.testing.assert_allclose(g.char_logps, w.char_logps, rtol=0, atol=TOL)
            if scores:
                np.testing.assert_allclose(g.score, w.score, rtol=0, atol=TOL)
                np.testing.assert_allclose(g.avg_logprob, w.avg_logprob, rtol=0, atol=TOL)
            assert [x["word"] for x in g.words()] == [x["word"] for x in w.words()]


@pytest.mark.parametrize("n_best,beam", [(1, 1), (3, 1), (2, 3)],
                         ids=["greedy", "nbest3", "beam3-nbest2"])
@pytest.mark.parametrize("timestamps", [True, False], ids=["timestamps", "no-timestamps"])
def test_transcribe_fbank_detailed_matches_jax(ckpts, rng, n_best, beam, timestamps):
    jt, pt = _pair(ckpts, beam=beam)
    fbs = _fbanks(rng)
    want = jt.transcribe_fbank_detailed(fbs, n_best=n_best, timestamps=timestamps)
    got = pt.transcribe_fbank_detailed(fbs, n_best=n_best, timestamps=timestamps)
    if n_best == 1 and beam == 1 and not timestamps:
        # greedy computes no score: NaN on both sides
        assert all(np.isnan(h.score) for row in got for h in row[:1] if h.text)
        _assert_hyps_equal(got, want, scores=False)
    else:
        _assert_hyps_equal(got, want)
    # the zero-frame row gets one empty hypothesis, the others n_best each
    assert len(got[2]) == 1 and got[2][0].text == "" and got[2][0].char_frames.size == 0
    assert [len(row) for i, row in enumerate(got) if i != 2] == [n_best] * 3
    with pytest.raises(ValueError, match="n_best must be >= 1"):
        pt.transcribe_fbank_detailed(fbs, n_best=0)
    assert pt.transcribe_fbank_detailed([]) == []


@pytest.mark.parametrize("with_lm", [False, True], ids=["asr", "asr+lm"])
def test_force_align_matches_jax(ckpts, rng, with_lm):
    jt, pt = _pair(ckpts, with_lm=with_lm)
    x = rng.standard_normal((3, 48, 40)).astype(np.float32)
    lens = np.asarray([48, 30, 9], np.int32)
    ids = rng.integers(2, 50, (3, 2, 16)).astype(np.int32)
    lm_j = jt.lm_params if with_lm else None
    lm_p = pt.lm if with_lm else None
    want = jalign.force_align_nbest(jt.params, jt.cfg, jnp.asarray(x), jnp.asarray(lens), ids,
                                    lm_params=lm_j, lm_cfg=jt.lm_cfg, lm_weight=0.5)
    got = align.force_align_nbest(pt.model, torch.from_numpy(x), torch.from_numpy(lens), ids,
                                  lm=lm_p, lm_weight=0.5)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=0, atol=TOL)
    # one utterance at a time equals the tiled pass
    one = align.force_align(pt.model, torch.from_numpy(x[:1]), torch.from_numpy(lens[:1]),
                            ids[:1, 0], lm=lm_p, lm_weight=0.5)
    np.testing.assert_array_equal(one[0], got[0][:1, 0])
    hyps = align.build_hypotheses(Mapper(), ids[:, 0], np.asarray([16, 5, 0]), got[0][:, 0],
                                  got[1][:, 0])
    want_h = jalign.build_hypotheses(Mapper(), ids[:, 0], np.asarray([16, 5, 0]),
                                     np.asarray(want[0])[:, 0], np.asarray(want[1])[:, 0])
    _assert_hyps_equal([hyps], [want_h])


def test_lm_score_and_rescore_match_jax(ckpts, rng):
    jt, pt = _pair(ckpts)
    toks = rng.integers(2, 50, (2, 3, 9)).astype(np.int32)
    lens = np.asarray([[9, 4, 0], [1, 7, 3]], np.int32)
    for b in range(2):
        for j in range(3):
            toks[b, j, lens[b, j]:] = 0
    want = jrescore.lm_score(jt.lm_params, jt.lm_cfg, toks, lens)
    got = rescore.lm_score(pt.lm, toks, lens)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    asr = rng.standard_normal((2, 3)).astype(np.float32)
    w = jrescore.rescore_nbest(toks, lens, asr, jt.lm_params, jt.lm_cfg, [0.0, 0.3, 1.0])
    g = rescore.rescore_nbest(toks, lens, asr, pt.lm, [0.0, 0.3, 1.0])
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_array_equal(g[k][0], w[k][0])
        np.testing.assert_allclose(g[k][1], w[k][1], rtol=0, atol=TOL)


def test_hypothesis_words():
    h = align.Hypothesis("ab cd", -2.0, -0.4, np.asarray([0.0, 0.08, 0.16, 0.24, 0.32], np.float32),
                         np.arange(5, dtype=np.int32),
                         np.asarray([-1, -1, 0, -0.5, -0.5], np.float32))
    words = h.words()
    assert [w["word"] for w in words] == ["ab", "cd"]
    assert words[1]["start"] == pytest.approx(0.24) and words[1]["end"] == pytest.approx(0.40)
    assert words[0]["avg_logprob"] == pytest.approx(-1.0)
    bare = align.Hypothesis("ab", -1.0, -0.5, np.zeros(0, np.float32), np.zeros(0, np.int32))
    assert bare.words() == [{"word": "ab", "start": 0.0, "end": 0.0, "avg_logprob": -0.5}]
