"""The port's serving path end to end, against the JAX package.

One tiny npz checkpoint written by the JAX package goes through both
``Transcriber``s: JAX with ``use_pallas_kernel=False`` (on the CPU its
kernel route would compile the TPU kernel without interpret mode; the JAX
package's own tests hold that route equal to this one), the port on the
CPU, where every kernel wrapper takes its plain version.  Transcripts must
be equal and the listener output within 1e-5.  Then the port's HTTP server
(every route: plain, detail / n-best, long-form, streaming, reload) and
transcription CLI run on the same checkpoint, against the direct
``Transcriber`` calls and the JAX CLI.
"""

import contextlib
import io
import json
import shutil
import threading
import time
import urllib.error
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss_asr_tpu import api as japi
from ss_asr_tpu.models import charlm as jcharlm
from ss_asr_tpu.models import las as jlas
from ss_asr_tpu.utils import checkpoint as jckpt
from ss_asr_tpu_torch import api, convert
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops.frontend import compute_fbank
from ss_asr_tpu_torch.serve import BatchingTranscriber, serve_http
from ss_asr_tpu_torch.streaming import StreamingTranscriber

torch.set_num_threads(1)

MDL = dict(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=40)
CONFIG = {"asr": {"mdl": MDL, "decode_beam_size": 1, "decode_lm_weight": 0.5},
          "char_lm": {"mdl": {"hidden_size": 8}}}
KW = dict(max_steps=8, sr=8000, t_bucket=16)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    asr = str(d / "asr.npz")
    lm = str(d / "char_lm.npz")
    jckpt.save_pytree(asr, jax.tree.map(np.asarray, jlas.init_asr(
        jax.random.key(0), jlas.ASRConfig(**MDL))))
    jckpt.save_pytree(lm, jax.tree.map(np.asarray, jcharlm.init_charlm(
        jax.random.key(1), jcharlm.CharLMConfig(hidden_size=8))))
    return asr, lm


def _pair(ckpts, with_lm=False):
    asr, lm = ckpts
    lm_path = lm if with_lm else None
    jt = japi.Transcriber.from_checkpoint(asr, CONFIG, lm_path=lm_path,
                                          use_pallas_kernel=False, **KW)
    pt = api.Transcriber.from_checkpoint(asr, CONFIG, lm_path=lm_path, device="cpu", **KW)
    return jt, pt


def _signals(rng, lens=(3000, 4500, 1, 6000, 0)):
    return [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in lens]


@pytest.mark.parametrize("with_lm", [False, True], ids=["greedy", "greedy+lm"])
def test_signal_batch_matches_jax(ckpts, rng, with_lm):
    jt, pt = _pair(ckpts, with_lm)
    sigs = _signals(rng)
    want = jt.transcribe_signal_batch(sigs)
    got = pt.transcribe_signal_batch(sigs)
    assert got == want
    assert got[4] == "" and all(isinstance(s, str) for s in got)
    assert pt.transcribe_signal_batch([]) == []
    assert pt.transcribe_signal_batch([np.zeros(0, np.float32)]) == [""]


def test_fbank_path_and_listener_match_jax(ckpts, rng):
    jt, pt = _pair(ckpts)
    fbs = [rng.standard_normal((n, 40)).astype(np.float32) for n in (30, 17, 0, 44)]
    assert pt.transcribe_fbank(fbs) == jt.transcribe_fbank(fbs)
    assert pt.transcribe_fbank(fbs[1]) == jt.transcribe_fbank(fbs[1])
    assert pt.transcribe_fbank([np.zeros((0, 40), np.float32)]) == [""]
    # the listener output itself, on the padded batch both APIs build
    x = np.zeros((3, 48, 40), np.float32)
    lens = np.asarray([30, 17, 44], np.int32)
    for i, f in enumerate((fbs[0], fbs[1], fbs[3])):
        x[i, : len(f)] = f
    want, wl = jlas.listener_apply(jt.params["encoder"], jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        got, gl = las.listener_apply(pt.model.encoder, torch.from_numpy(x),
                                     torch.from_numpy(lens))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_transcribe_wav_matches_jax(ckpts, rng, tmp_path):
    jt, pt = _pair(ckpts)
    p = str(tmp_path / "u.wav")
    _write_wav(p, _signals(rng, (7000,))[0], 16000)  # resampled to 8000 on load
    assert pt.transcribe_wav(p) == jt.transcribe_wav(p)


def test_unported_paths_name_their_roadmap_item(ckpts, rng):
    """Only mesh serving is left unported; the config's beam (the former
    ROADMAP item 2) now decodes, equal to JAX."""
    asr, lm = ckpts
    pt = api.Transcriber.from_checkpoint(asr, CONFIG, device="cpu", **KW)
    with pytest.raises(NotImplementedError, match="ROADMAP.md port item 10"):
        api.Transcriber(pt.model, mesh=object())
    with pytest.raises(ValueError, match="outside 1..16"):
        api.Transcriber(pt.model, beam_size=17)
    beam_cfg = {**CONFIG, "asr": {**CONFIG["asr"], "decode_beam_size": 3}}
    jt = japi.Transcriber.from_checkpoint(asr, beam_cfg, lm_path=lm, use_pallas_kernel=False,
                                          **KW)
    bt = api.Transcriber.from_checkpoint(asr, beam_cfg, lm_path=lm, device="cpu", **KW)
    assert (bt.beam_size, bt.lm_weight) == (3, 0.5)
    sigs = _signals(rng)
    assert bt.transcribe_signal_batch(sigs) == jt.transcribe_signal_batch(sigs)
    fbs = [rng.standard_normal((n, 40)).astype(np.float32) for n in (30, 0, 44)]
    assert bt.transcribe_fbank(fbs) == jt.transcribe_fbank(fbs)


def _write_wav(path_or_buf, y, sr):
    with wave.open(path_or_buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(y, -1, 1) * 32767).astype(np.int16).tobytes())


def _wav_bytes(y, sr):
    buf = io.BytesIO()
    _write_wav(buf, y, sr)
    return buf.getvalue()


@contextlib.contextmanager
def _serving(bt, reload_paths=None):
    """The port's HTTP server over ``bt`` on a free local port -> (post, get)."""
    ready = threading.Event()
    server = serve_http(bt, host="127.0.0.1", port=0, ready_event=ready,
                        reload_paths=reload_paths)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    # the server is local: never route its requests through an environment proxy
    urlopen = urllib.request.build_opener(urllib.request.ProxyHandler({})).open

    def post(path, body=b""):
        try:
            with urlopen(urllib.request.Request(base + path, data=body), timeout=120) as r:
                return r.status, json.load(r)
        except urllib.error.HTTPError as e:
            return e.code, json.load(e)

    def get(path):
        with urlopen(base + path, timeout=30) as r:
            return json.load(r)

    try:
        yield post, get
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("mode", ["signal", "fbank"])
def test_http_server_answers_like_the_direct_path(ckpts, rng, mode):
    _, pt = _pair(ckpts)
    sigs = _signals(rng, (3000, 4400, 5200))
    bodies = [_wav_bytes(s, 8000) for s in sigs]
    from ss_asr_tpu_torch.data.audio import read_wav

    read = [read_wav(io.BytesIO(b))[1] for b in bodies]
    direct = pt.transcribe_signal_batch(read)
    with BatchingTranscriber(pt, max_batch=4, max_wait_ms=200, mode=mode) as bt, \
            _serving(bt) as (post, get):
        results = [None] * len(bodies)

        def worker(i):
            results[i] = post("/transcribe", bodies[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(not t.is_alive() for t in threads)
        assert [r[0] for r in results] == [200] * len(bodies)
        texts = [r[1]["text"] for r in results]
        if mode == "signal":
            assert texts == direct
        else:  # per-request frontend: the fbank path on the same frames
            assert texts == pt.transcribe_fbank([compute_fbank(y, 8000, device="cpu") for y in read])
        assert post("/transcribe", b"not a wav")[0] == 400

        # detail / n-best: the direct detailed decode of the same frames
        want = pt.transcribe_fbank_detailed(compute_fbank(read[1], 8000, device="cpu"), n_best=3)[0]
        code, obj = post("/transcribe?detail=1&nbest=3", bodies[1])
        assert code == 200 and obj["text"] == want[0].text
        assert [h["text"] for h in obj["hypotheses"]] == [h.text for h in want]
        assert [h["char_starts"] for h in obj["hypotheses"]] == [
            [round(float(c), 3) for c in h.char_starts] for h in want]
        np.testing.assert_allclose([h["score"] for h in obj["hypotheses"]],
                                   [h.score for h in want], rtol=0, atol=1e-6)
        assert all({"word", "start", "end", "avg_logprob"} == set(w)
                   for h in obj["hypotheses"] for w in h["words"])
        code, obj = post("/transcribe?detail=1", bodies[0])
        assert code == 200 and len(obj["hypotheses"]) == 1
        assert post("/transcribe?nbest=17", bodies[0])[0] == 400
        assert post("/transcribe?long=1&nbest=2", bodies[0])[0] == 400
        assert post("/transcribe?vad=webrtc", bodies[0])[0] == 400

        # long-form: the direct windowed decode
        code, obj = post("/transcribe?long=1&window_s=0.3&overlap_s=0.1", bodies[2])
        assert code == 200
        assert obj["text"] == pt.transcribe_long(read[2], 8000, window_s=0.3, overlap_s=0.1)
        code, obj = post("/transcribe?long=1&window_s=0.3&overlap_s=0.1&vad=energy", bodies[2])
        assert code == 200 and obj["text"] == pt.transcribe_long(
            read[2], 8000, window_s=0.3, overlap_s=0.1, vad="energy")

        # a stream session: create, feed PCM16 chunks, end
        code, obj = post("/stream?window_s=0.5&min_segment_s=0.2")
        assert code == 200 and obj["sr"] == 8000
        sid = obj["id"]
        pcm = (np.clip(read[2], -1, 1) * 32767).astype("<i2")
        ref = StreamingTranscriber(pt, commit_window_s=0.5, min_segment_s=0.2)
        for c in np.array_split(pcm, 3):
            code, obj = post(f"/stream/{sid}", c.tobytes())
            ref.feed(c.astype(np.float32) / 32768.0)
            assert code == 200 and obj == {"partial": ref.partial(),
                                           "committed": ref.committed_text}
        assert post(f"/stream/{sid}", b"\x00")[0] == 400
        assert post(f"/stream/{sid}/end") == (200, {"text": ref.finalize()})
        assert post(f"/stream/{sid}/end")[0] == 404
        assert post("/stream?sr=100")[0] == 400
        assert post("/reload")[0] == 404  # started without checkpoint paths
        assert get("/healthz") == {"ok": True}
        stats = get("/stats")
    assert stats["requests"] == len(bodies) and stats["batches"] >= 1
    assert stats["detail_requests"] == 4 and stats["stream_requests"] == 4
    assert bt.stats.rows_sum == bt.stats.requests + bt.stats.padded_rows


def test_http_reload_swaps_the_weights(ckpts, rng, tmp_path):
    """/reload re-reads the checkpoints the server started with: 200 and the
    new weights; 500 on a checkpoint of another size, the old weights
    serving on."""
    asr, lm = ckpts
    live_asr, live_lm = str(tmp_path / "asr.npz"), str(tmp_path / "lm.npz")
    shutil.copy(asr, live_asr)
    shutil.copy(lm, live_lm)
    pt = api.Transcriber.from_checkpoint(live_asr, CONFIG, lm_path=live_lm, device="cpu", **KW)
    y = _signals(rng, (5000,))[0]
    body = _wav_bytes(y, 8000)
    from ss_asr_tpu_torch.data.audio import read_wav

    y = read_wav(io.BytesIO(body))[1]
    with BatchingTranscriber(pt, max_batch=2, max_wait_ms=1, mode="signal") as bt, \
            _serving(bt, {"asr": live_asr, "lm": live_lm}) as (post, _):
        before = post("/transcribe", body)
        assert before == (200, {"text": pt.transcribe_signal(y)})
        jckpt.save_pytree(live_asr, jax.tree.map(np.asarray, jlas.init_asr(
            jax.random.key(5), jlas.ASRConfig(**MDL))))
        assert post("/reload") == (200, {"reloaded": live_asr})
        fresh = api.Transcriber.from_checkpoint(live_asr, CONFIG, lm_path=live_lm, device="cpu",
                                                **KW)
        after = post("/transcribe", body)
        assert after == (200, {"text": fresh.transcribe_signal(y)})
        assert after != before
        jckpt.save_pytree(live_asr, jax.tree.map(np.asarray, jlas.init_asr(
            jax.random.key(6), jlas.ASRConfig(**{**MDL, "encoder_state_size": 16}))))
        code, obj = post("/reload")
        assert code == 500 and "shape" in obj["error"]
        assert post("/transcribe", body) == after


def test_reload_params_checks_before_it_swaps(ckpts):
    asr, lm = ckpts
    pt = api.Transcriber.from_checkpoint(asr, CONFIG, device="cpu", **KW)
    state = {k: v.clone() for k, v in pt.model.state_dict().items()}
    lm_state = convert.charlm_state_from_params(jckpt.load_pytree(lm))
    with BatchingTranscriber(pt, max_batch=2) as bt:
        w = pt._w
        with pytest.raises(ValueError, match="without an LM"):
            bt.reload_params(state, lm_state)
        with pytest.raises(ValueError, match="keys differ"):
            bt.reload_params({k: v for k, v in state.items() if k != "embed.weight"})
        assert pt._w is w
        bt.reload_params(state)
        assert pt._w is not w and pt.model is not w[0]


def test_reload_between_batches_never_mixes_asr_and_lm(ckpts, monkeypatch):
    """Decodes racing reloads: every decode gets the ASR and the LM of ONE
    generation (generation g marks both with a bias of g)."""
    asr, lm = ckpts
    pt = api.Transcriber.from_checkpoint(asr, {**CONFIG, "asr": {**CONFIG["asr"],
                                                                 "decode_beam_size": 2}},
                                         lm_path=lm, device="cpu", **KW)
    seen = []
    real = api.beam_decode

    def recording(model, x, lens, lm=None, **kw):
        seen.append((float(model.char_trans.bias[0].detach()), float(lm.out.bias[0].detach())))
        time.sleep(0.002)  # widen the window for a reload to land mid-decode
        return real(model, x, lens, lm=lm, **kw)

    monkeypatch.setattr(api, "beam_decode", recording)
    asr_state = {k: v.clone() for k, v in pt.model.state_dict().items()}
    lm_state = {k: v.clone() for k, v in pt.lm.state_dict().items()}
    stop = threading.Event()

    def reloads(bt):
        g = 0
        while not stop.is_set():
            g += 1
            asr_state["char_trans.bias"][0] = g
            lm_state["out.bias"][0] = g
            bt.reload_params(asr_state, lm_state)

    fb = np.random.default_rng(0).standard_normal((20, 40)).astype(np.float32)
    with BatchingTranscriber(pt, max_batch=2) as bt:
        th = threading.Thread(target=reloads, args=(bt,))
        th.start()
        try:
            for _ in range(30):
                bt.submit(fb).result(timeout=60)
        finally:
            stop.set()
            th.join(timeout=60)
    assert len(seen) == 30 and len({a for a, _ in seen}) > 1
    assert all(a == b for a, b in seen)


def test_transcribe_cli_prints_tsv(ckpts, rng, tmp_path, capsys):
    from ss_asr_tpu.cli import transcribe as jtranscribe
    from ss_asr_tpu_torch.cli import transcribe

    asr, _ = ckpts
    cfg = tmp_path / "exp.yaml"
    cfg.write_text(json.dumps(CONFIG))  # JSON is YAML
    sigs = _signals(rng, (3000, 4000))
    paths = []
    for i, y in enumerate(sigs):
        p = str(tmp_path / f"u{i}.wav")
        _write_wav(p, y, 8000)
        paths.append(p)
    npy = str(tmp_path / "f.npy")
    np.save(npy, rng.standard_normal((20, 40)).astype(np.float32))
    common = ["--config", str(cfg), "--sr", "8000", "--max-steps", "8", "--batch", "2"]
    transcribe.main([asr, *paths, npy, *common, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().split("\n")
    assert [ln.split("\t")[0] for ln in lines] == [*paths, npy]
    pt = api.Transcriber.from_checkpoint(asr, CONFIG, device="cpu", max_steps=8, sr=8000)
    want = pt.transcribe_fbank([np.load(npy)])[0]
    assert lines[2] == f"{npy}\t{want}"

    # --long and --nbest print what the JAX CLI prints
    long_args = [asr, *paths, *common, "--long", "--window-s", "0.2", "--overlap-s", "0.05"]
    jtranscribe.main(long_args)
    want = capsys.readouterr().out
    transcribe.main([*long_args, "--device", "cpu"])
    assert capsys.readouterr().out == want
    nbest_args = [asr, *paths, npy, *common, "--nbest", "2"]
    jtranscribe.main(nbest_args)
    want = [json.loads(ln) for ln in capsys.readouterr().out.strip().split("\n")]
    transcribe.main([*nbest_args, "--device", "cpu"])
    got = [json.loads(ln) for ln in capsys.readouterr().out.strip().split("\n")]
    assert [(g["path"], g["text"]) for g in got] == [(w["path"], w["text"]) for w in want]
    for g, w in zip(got, want):
        assert len(g["hypotheses"]) == len(w["hypotheses"]) == 2
        for gh, wh in zip(g["hypotheses"], w["hypotheses"]):
            assert (gh["text"], gh["char_starts"]) == (wh["text"], wh["char_starts"])
            assert [x["word"] for x in gh["words"]] == [x["word"] for x in wh["words"]]
            # scores print rounded to 4 places; the two sides agree within 1e-4
            assert abs(gh["score"] - wh["score"]) <= 2e-4
    with pytest.raises(SystemExit, match="exclusive"):
        transcribe.main([asr, paths[0], *common, "--long", "--nbest", "2", "--device", "cpu"])
