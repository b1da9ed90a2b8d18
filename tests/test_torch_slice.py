"""The port's greedy serving slice end to end, against the JAX package.

One tiny npz checkpoint written by the JAX package goes through both
``Transcriber``s: JAX with ``use_pallas_kernel=False`` (on the CPU its
kernel route would compile the TPU kernel without interpret mode; the JAX
package's own tests hold that route equal to this one), the port on the
CPU, where every kernel wrapper takes its plain version.  Transcripts must
be equal and the listener output within 1e-5.  Then the port's HTTP server
and transcription CLI run on the same checkpoint.
"""

import io
import json
import threading
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
from ss_asr_tpu_torch import api
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops.frontend import compute_fbank
from ss_asr_tpu_torch.serve import BatchingTranscriber, serve_http

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


def test_unported_paths_name_their_roadmap_item(ckpts):
    asr, _ = ckpts
    with pytest.raises(NotImplementedError, match="ROADMAP.md port item 2"):
        api.Transcriber.from_checkpoint(asr, {"asr": {"mdl": MDL, "decode_beam_size": 3}},
                                        device="cpu")
    pt = api.Transcriber.from_checkpoint(asr, CONFIG, device="cpu", **KW)
    with pytest.raises(NotImplementedError, match="ROADMAP.md port item 2"):
        api.Transcriber(pt.model, beam_size=4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md port item 9"):
        api.Transcriber(pt.model, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP.md port item 3"):
        pt.transcribe_fbank_detailed([np.zeros((5, 40), np.float32)])
    with pytest.raises(NotImplementedError, match="ROADMAP.md port item 4"):
        pt.transcribe_long(np.zeros(100, np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP.md port item 4"):
        pt.transcribe_stream([np.zeros(100, np.float32)])


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


@pytest.mark.parametrize("mode", ["signal", "fbank"])
def test_http_server_answers_like_the_direct_path(ckpts, rng, mode):
    _, pt = _pair(ckpts)
    sigs = _signals(rng, (3000, 4400, 5200))
    bodies = [_wav_bytes(s, 8000) for s in sigs]
    from ss_asr_tpu_torch.data.audio import read_wav

    read = [read_wav(io.BytesIO(b))[1] for b in bodies]
    direct = pt.transcribe_signal_batch(read)
    ready = threading.Event()
    with BatchingTranscriber(pt, max_batch=4, max_wait_ms=200, mode=mode) as bt:
        server = serve_http(bt, host="127.0.0.1", port=0, ready_event=ready)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        # the server is local: never route its requests through an environment proxy
        urlopen = urllib.request.build_opener(urllib.request.ProxyHandler({})).open

        def post(path, body):
            try:
                with urlopen(urllib.request.Request(base + path, data=body), timeout=120) as r:
                    return r.status, json.load(r)
            except urllib.error.HTTPError as e:
                return e.code, json.load(e)

        try:
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
                assert texts == pt.transcribe_fbank([compute_fbank(y, 8000) for y in read])
            assert post("/transcribe", b"not a wav")[0] == 400
            code, obj = post("/transcribe?nbest=2", bodies[0])
            assert code == 501 and "ROADMAP.md port item 3" in obj["error"]
            assert post("/transcribe?detail=1", bodies[0])[0] == 501
            assert post("/transcribe?long=1", bodies[0])[0] == 501
            assert post("/stream", b"")[0] == 501
            assert post("/reload", b"")[0] == 501
            with urlopen(base + "/healthz", timeout=30) as r:
                assert json.load(r) == {"ok": True}
            with urlopen(base + "/stats", timeout=30) as r:
                stats = json.load(r)
            assert stats["requests"] == len(bodies) and stats["batches"] >= 1
        finally:
            server.shutdown()
            server.server_close()
    assert bt.stats.rows_sum == bt.stats.requests + bt.stats.padded_rows


def test_transcribe_cli_prints_tsv(ckpts, rng, tmp_path, capsys):
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
    transcribe.main([asr, *paths, npy, "--config", str(cfg), "--sr", "8000", "--max-steps", "8",
                     "--batch", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().split("\n")
    assert [ln.split("\t")[0] for ln in lines] == [*paths, npy]
    pt = api.Transcriber.from_checkpoint(asr, CONFIG, device="cpu", max_steps=8, sr=8000)
    want = pt.transcribe_fbank([np.load(npy)])[0]
    assert lines[2] == f"{npy}\t{want}"
    with pytest.raises(SystemExit, match="ROADMAP.md port item 4"):
        transcribe.main([asr, paths[0], "--long", "--device", "cpu"])
    with pytest.raises(SystemExit, match="ROADMAP.md port item 3"):
        transcribe.main([asr, paths[0], "--nbest", "2", "--device", "cpu"])
