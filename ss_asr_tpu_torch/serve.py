"""Dynamic-batching serving runtime over the Transcriber API.

Port of ``ss_asr_tpu/serve.py`` (``ServeStats``, ``_lattice``,
``BatchingTranscriber`` with hot reload, and ``serve_http``), over a
single-device or a mesh ``Transcriber``.
Concurrent requests are coalesced into one decode call; the row count is
padded up a power-of-two lattice with empty rows (their transcripts are
dropped), so a batch's shape comes from a small set.

    t = Transcriber.from_checkpoint("asr.npz", config)
    with BatchingTranscriber(t, max_batch=16, max_wait_ms=5, mode="signal") as bt:
        serve_http(bt, port=8000, reload_paths={"asr": "asr.npz", "lm": None})

``serve_http`` answers ``POST /transcribe`` (WAV body -> {"text": ...};
``?detail`` / ``?nbest=N`` for n-best hypotheses with confidence and
timestamps, ``?long`` for the windowed long-form decode), the ``/stream``
session routes, ``POST /reload``, ``GET /healthz`` and ``GET /stats``, with
the JAX server's limits and status codes.
"""

from __future__ import annotations

import copy
import io
import json
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

#: recent-window length for the percentile deques below — the exact
#: counters never truncate
STATS_WINDOW = 4096

#: HTTP detail-path limits: nbest sizes the beam (at most the beam
#: kernel's width), and detail requests bypass the batcher's admission
#: control, so they get their own gate
MAX_NBEST = 16
MAX_DETAIL_CONCURRENCY = 2

#: HTTP streaming-session limits: each open session buffers up to one
#: commit window of frames, so both bound server memory; idle sessions are
#: reaped lazily on the next /stream request
MAX_STREAM_SESSIONS = 16
STREAM_IDLE_TTL_S = 300.0


@dataclass
class ServeStats:
    """Batching counters (guarded by the owner's lock).  ``requests`` /
    ``batches`` / ``padded_rows`` / ``rows_sum`` are exact
    (``rows_sum == requests + padded_rows`` once drained); ``batch_sizes``
    and ``wait_ms`` are bounded recent windows."""

    requests: int = 0
    batches: int = 0
    padded_rows: int = 0
    rows_sum: int = 0
    detail_requests: int = 0  # HTTP ?detail / ?nbest / ?long (bypass the batcher)
    detail_rejected: int = 0  # shed at the detail admission gate
    stream_requests: int = 0  # HTTP /stream feed and end calls
    stream_rejected: int = 0  # session table full
    batch_sizes: deque = field(default_factory=lambda: deque(maxlen=STATS_WINDOW))
    wait_ms: deque = field(default_factory=lambda: deque(maxlen=STATS_WINDOW))

    def as_dict(self) -> dict:
        d = {"requests": self.requests, "batches": self.batches,
             "padded_rows": self.padded_rows, "detail_requests": self.detail_requests,
             "detail_rejected": self.detail_rejected, "stream_requests": self.stream_requests,
             "stream_rejected": self.stream_rejected}
        if self.batches:
            d["mean_batch"] = self.rows_sum / self.batches
        if self.wait_ms:
            w = sorted(self.wait_ms)
            d["queue_wait_p50_ms"] = round(w[len(w) // 2], 3)
            d["queue_wait_p99_ms"] = round(w[min(len(w) - 1, int(len(w) * 0.99))], 3)
        return d


def _lattice(max_batch: int) -> tuple:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


class BatchingTranscriber:
    """Thread-safe dynamic batcher in front of a Transcriber.

    ``submit`` enqueues one request — a ``[T, feature_dim]`` fbank in
    'fbank' mode, a 1-D waveform in 'signal' mode — and returns a Future of
    its transcript.  A worker thread takes the oldest request, waits up to
    ``max_wait_ms`` for the batch to fill to ``max_batch``, pads the row
    count up the lattice with empty rows and resolves the futures in
    submission order.  A failed decode fails that batch's futures, not the
    server.  ``close()`` drains the queue before stopping.
    """

    def __init__(self, transcriber, max_batch: int = 16, max_wait_ms: float = 5.0,
                 mode: str = "fbank", sr: Optional[int] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if mode not in ("fbank", "signal"):
            raise ValueError(f"mode must be 'fbank' or 'signal', got {mode!r}")
        self._t = transcriber
        self.mode = mode
        #: sample rate of submitted waveforms (signal mode)
        self.sr = sr or transcriber.sr
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._lattice = _lattice(self.max_batch)
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self.stats = ServeStats()
        self._worker = threading.Thread(target=self._run, name="ss-asr-serve-batcher",
                                        daemon=True)
        self._worker.start()

    # -- client side ---------------------------------------------------
    def submit(self, item: np.ndarray) -> Future:
        item = np.asarray(item, dtype=np.float32)
        if self.mode == "signal":
            if item.ndim != 1:
                raise ValueError(f"expected 1-D waveform in signal mode, got shape {item.shape}")
        elif item.ndim != 2 or item.shape[1] != self._t.cfg.feature_dim:
            raise ValueError(f"expected [T, {self._t.cfg.feature_dim}] fbank, "
                             f"got shape {item.shape}")
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("BatchingTranscriber is closed")
            self._q.append((item, fut, time.perf_counter()))
            self.stats.requests += 1
            self._cv.notify()
        return fut

    def transcribe_fbank(self, fbanks: Sequence[np.ndarray]) -> List[str]:
        futs = [self.submit(f) for f in fbanks]
        return [f.result() for f in futs]

    @staticmethod
    def _check_like(new: dict, live, what: str) -> None:
        """``new`` must have the live module's state_dict keys and shapes."""
        old = live.state_dict()
        if set(new) != set(old):
            diff = sorted(set(new) ^ set(old))[:4]
            raise ValueError(f"reload {what}: state_dict keys differ from the live model's "
                             f"(different model config?): {diff}")
        for k, v in old.items():
            if tuple(new[k].shape) != tuple(v.shape):
                raise ValueError(f"reload {what}: {k} has shape {tuple(new[k].shape)}, the live "
                                 f"model {tuple(v.shape)} (different model size?)")

    def reload_params(self, asr_state: dict, lm_state: Optional[dict] = None) -> None:
        """Hot-swap the weights without dropping requests.

        ``asr_state`` / ``lm_state`` are state_dicts of the live modules'
        layout (``convert.asr_state_from_params`` of a checkpoint).  Keys
        and shapes are checked first, so a checkpoint of another size is
        rejected before anything changes; an LM is rejected when the server
        has none.  The new modules are built beside the live ones (and
        replicated onto every mesh device) and the (ASR, LM) pair swaps in
        ONE assignment: a batch in flight finishes on the old pair, every
        later one uses the new, never a mix."""
        t = self._t
        model, lm, _ = t._w
        self._check_like(asr_state, model, "asr")
        if lm_state is not None:
            if lm is None:
                raise ValueError("reload lm: the server was built without an LM (the "
                                 "fusion weight and the decode would change); restart to add one")
            self._check_like(lm_state, lm, "lm")
        new_model = copy.deepcopy(model)
        new_model.load_state_dict(asr_state)
        new_lm = lm
        if lm_state is not None:
            new_lm = copy.deepcopy(lm)
            new_lm.load_state_dict(lm_state)
        # with a mesh Transcriber the new pair is placed on every mesh device first
        t._w = t.replicate(new_model.eval(), new_lm)

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop accepting work, drain the queue, join the worker."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker side ----------------------------------------------------
    def _take_batch(self):
        with self._cv:
            while not self._q and not self._closed:
                self._cv.wait()
            if not self._q:
                return None  # closed and drained
            deadline = time.perf_counter() + self.max_wait_s
            while len(self._q) < self.max_batch and not self._closed:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                self._cv.wait(timeout=left)
            n = min(len(self._q), self.max_batch)
            return [self._q.popleft() for _ in range(n)]

    def _run(self):
        if self.mode == "signal":
            pad_row = np.zeros((0,), np.float32)

            def decode(items):
                return self._t.transcribe_signal_batch(items, sr=self.sr)
        else:
            pad_row = np.zeros((0, self._t.cfg.feature_dim), np.float32)
            decode = self._t.transcribe_fbank
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            # RUNNING from here on: a late cancel() is a no-op, so the
            # set_result/set_exception below cannot race it
            batch = [b for b in batch if b[1].set_running_or_notify_cancel()]
            if not batch:
                continue
            items = [b[0] for b in batch]
            futs = [b[1] for b in batch]
            now = time.perf_counter()
            waits = [(now - b[2]) * 1e3 for b in batch]
            padded = next(b for b in self._lattice if b >= len(items))
            n_pad = padded - len(items)
            items.extend(pad_row for _ in range(n_pad))
            try:
                texts = decode(items)
            except Exception as e:  # noqa: BLE001 — fail the batch, not the server
                for f in futs:
                    f.set_exception(e)
                continue
            with self._cv:
                self.stats.batches += 1
                self.stats.padded_rows += n_pad
                self.stats.rows_sum += padded
                self.stats.batch_sizes.append(padded)
                self.stats.wait_ms.extend(waits)
            for f, text in zip(futs, texts):
                f.set_result(text)


# ----------------------------------------------------------------------
def hypothesis_json(h, digits: Optional[int] = None) -> dict:
    """One Hypothesis as the HTTP server prints it (the CLI rounds score
    and avg_logprob to ``digits``)."""
    score, conf = h.score, h.avg_logprob
    if digits is not None:
        score, conf = round(score, digits), round(conf, digits)
    return {
        "text": h.text,
        "score": score,
        "avg_logprob": conf,
        "char_starts": [round(float(c), 3) for c in h.char_starts],
        "words": [{"word": w["word"], "start": round(w["start"], 3), "end": round(w["end"], 3),
                   "avg_logprob": round(w["avg_logprob"], 4)} for w in h.words()],
    }


def serve_http(
    batcher: BatchingTranscriber,
    host: str = "127.0.0.1",
    port: int = 8000,
    sr: Optional[int] = None,
    ready_event: Optional[threading.Event] = None,
    reload_paths: Optional[dict] = None,
):
    """Blocking threaded HTTP server over a BatchingTranscriber.

    POST /transcribe   body = WAV bytes -> {"text": "..."}
                       ?detail=1 / ?nbest=N (N <= MAX_NBEST): n-best
                       hypotheses with score, confidence and per-character
                       and per-word times; ?long=1 [&window_s=&overlap_s=
                       &vad=energy]: windowed long-form decode
    POST /stream[...]  streaming sessions: create, feed raw PCM16 chunks for
                       partials, end (see ``_handle_stream``)
    POST /reload       hot-swap the weights from ``reload_paths`` ({"asr":
                       path, "lm": path or None}, the checkpoints the server
                       started with); 404 without them.  Batches in flight
                       finish on the old weights.
    GET  /healthz      -> {"ok": true}
    GET  /stats        -> batching counters (ServeStats.as_dict)

    In 'signal' mode the waveform goes to the batcher and the frontend runs
    with the batch; in 'fbank' mode each request thread computes its own
    frontend first.  The detail, long-form and stream paths bypass the
    batcher and share one admission gate (at capacity: 503).  Returns the
    server if ``ready_event`` is given (the caller drives
    ``serve_forever``); otherwise serves until interrupted.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    from ss_asr_tpu_torch import convert
    from ss_asr_tpu_torch.data.audio import read_wav, resample
    from ss_asr_tpu_torch.ops.frontend import compute_fbank
    from ss_asr_tpu_torch.streaming import StreamingTranscriber
    from ss_asr_tpu_torch.utils import checkpoint as ckpt

    if batcher.mode == "signal":
        if sr is not None and sr != batcher.sr:
            raise ValueError(f"serve_http sr={sr} != batcher sr={batcher.sr} (signal mode "
                             "decodes at the batcher's rate; pass sr= to "
                             "BatchingTranscriber instead)")
        target_sr = batcher.sr
    else:
        target_sr = sr or batcher._t.sr
    t = batcher._t
    feat = t.cfg.feature_dim
    detail_gate = threading.Semaphore(MAX_DETAIL_CONCURRENCY)
    # streaming sessions: id -> {st, lock, last}; the table lock guards the
    # dict, each session's lock serialises its feeds
    stream_lock = threading.Lock()
    stream_sessions: dict = {}

    def _count(name: str) -> None:
        with batcher._cv:
            setattr(batcher.stats, name, getattr(batcher.stats, name) + 1)

    def _reap_streams() -> None:
        now = time.monotonic()
        with stream_lock:
            for sid in [k for k, v in stream_sessions.items()
                        if now - v["last"] > STREAM_IDLE_TTL_S]:
                del stream_sessions[sid]

    def _flag(q: dict, name: str) -> bool:
        return q.get(name, ["0"])[0] not in ("0", "", "false")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; stats carry the signal
            pass

        def _reply(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _gated(self, fn) -> None:
            """Run ``fn`` (which replies) inside the detail admission gate."""
            if not detail_gate.acquire(timeout=30.0):
                _count("detail_rejected")
                self._reply(503, {"error": "detail path saturated"})
                return
            try:
                fn()
            finally:
                detail_gate.release()

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            elif self.path == "/stats":
                with batcher._cv:
                    d = batcher.stats.as_dict()
                self._reply(200, d)
            else:
                self._reply(404, {"error": "not found"})

        def _handle_reload(self):
            if not reload_paths or not reload_paths.get("asr"):
                self._reply(404, {"error": "server started without reloadable checkpoint paths"})
                return
            try:
                asr = convert.asr_state_from_params(ckpt.load_pytree(reload_paths["asr"]))
                lm = None
                if reload_paths.get("lm"):
                    lm = convert.charlm_state_from_params(ckpt.load_pytree(reload_paths["lm"]))
                batcher.reload_params(asr, lm)
                self._reply(200, {"reloaded": reload_paths["asr"]})
            except Exception as e:  # noqa: BLE001 — keep serving the old weights
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def _handle_stream(self, url):
            """Streaming sessions (``streaming.py`` over HTTP):

            POST /stream?sr=S&window_s=W&min_segment_s=M -> {"id", "sr"}
            POST /stream/<id>   body = PCM16LE mono     -> {"partial", "committed"}
            POST /stream/<id>/end                       -> {"text"}

            Chunks are raw little-endian int16 mono at the session's sr;
            partial text may be revised until its segment commits,
            committed text never is."""
            _reap_streams()
            parts = url.path.strip("/").split("/")
            if parts == ["stream"]:  # create
                try:
                    q = parse_qs(url.query)
                    s_sr = int(q.get("sr", [str(target_sr)])[0])
                    window_s = float(q.get("window_s", ["20"])[0])
                    min_seg = float(q.get("min_segment_s", ["2"])[0])
                    if not 4000 <= s_sr <= 48000:
                        raise ValueError(f"sr {s_sr} outside [4000, 48000]")
                    if not 0 < min_seg < window_s <= 120:
                        raise ValueError("need 0 < min_segment_s < window_s <= 120")
                except Exception as e:  # noqa: BLE001 — bad query -> 400
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                import uuid

                with stream_lock:
                    if len(stream_sessions) >= MAX_STREAM_SESSIONS:
                        _count("stream_rejected")
                        self._reply(503, {"error": "stream sessions full"})
                        return
                    sid = uuid.uuid4().hex[:16]
                    stream_sessions[sid] = {
                        "st": StreamingTranscriber(t, sr=s_sr, commit_window_s=window_s,
                                                   min_segment_s=min_seg),
                        "lock": threading.Lock(),
                        "last": time.monotonic(),
                    }
                self._reply(200, {"id": sid, "sr": s_sr})
                return
            if not (len(parts) == 2 or (len(parts) == 3 and parts[2] == "end")):
                self._reply(404, {"error": "not found"})
                return
            with stream_lock:
                sess = stream_sessions.get(parts[1])
            if sess is None:
                self._reply(404, {"error": "no such stream"})
                return
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n) if n else b""
            if len(body) % 2:
                self._reply(400, {"error": "odd PCM16 byte count"})
                return

            def feed():
                try:
                    _count("stream_requests")
                    with sess["lock"]:
                        sess["last"] = time.monotonic()
                        st = sess["st"]
                        if len(parts) == 3:  # /end
                            text = st.finalize()
                            with stream_lock:
                                stream_sessions.pop(parts[1], None)
                            self._reply(200, {"text": text})
                            return
                        if body:
                            st.feed(np.frombuffer(body, "<i2").astype(np.float32) / 32768.0)
                        self._reply(200, {"partial": st.partial(),
                                          "committed": st.committed_text})
                except Exception as e:  # noqa: BLE001 — one stream's failure is a 5xx
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

            self._gated(feed)

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/reload":
                self._handle_reload()
                return
            if url.path == "/stream" or url.path.startswith("/stream/"):
                self._handle_stream(url)
                return
            if url.path != "/transcribe":
                self._reply(404, {"error": "not found"})
                return
            try:  # client-side failures: unparseable body/query -> 400
                q = parse_qs(url.query)
                detail = _flag(q, "detail")
                long_form = _flag(q, "long")
                window_s = float(q.get("window_s", ["20"])[0])
                overlap_s = float(q.get("overlap_s", ["2"])[0])
                vad = q.get("vad", [None])[0]
                n_best = max(1, int(q.get("nbest", ["1"])[0]))
                if vad not in (None, "energy"):
                    raise ValueError("vad must be 'energy'")
                if long_form and not 0 < overlap_s < window_s <= 120:
                    raise ValueError("need 0 < overlap_s < window_s <= 120")
                if long_form and (detail or n_best > 1):
                    raise ValueError("long and detail/nbest are exclusive")
                if n_best > MAX_NBEST:
                    raise ValueError(f"nbest > {MAX_NBEST}")
                n = int(self.headers.get("Content-Length", 0))
                wav_sr, y = read_wav(io.BytesIO(self.rfile.read(n)))
                if wav_sr != target_sr:
                    y = resample(y, wav_sr, target_sr)
            except Exception as e:  # noqa: BLE001 — bad input must not kill the server
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:  # server-side failures: frontend/decode/shutdown -> 500
                if y.size == 0:
                    self._reply(200, {"text": ""})
                    return
                y = np.asarray(y, np.float32)
                if long_form:
                    def long_form_reply():
                        _count("detail_requests")
                        self._reply(200, {"text": t.transcribe_long(
                            y, target_sr, window_s=window_s, overlap_s=overlap_s, vad=vad)})

                    self._gated(long_form_reply)
                    return
                if detail or n_best > 1:
                    def detail_reply():
                        _count("detail_requests")
                        fb = compute_fbank(y, target_sr, n_mels=feat, device=t.device)
                        (hyps,) = t.transcribe_fbank_detailed(fb, n_best=n_best)
                        self._reply(200, {"text": hyps[0].text,
                                          "hypotheses": [hypothesis_json(h) for h in hyps]})

                    self._gated(detail_reply)
                    return
                if batcher.mode == "signal":
                    item = y
                else:
                    item = compute_fbank(y, target_sr, n_mels=feat, device=t.device)
                self._reply(200, {"text": batcher.submit(item).result()})
            except Exception as e:  # noqa: BLE001 — a failed batch is a 5xx, not a crash
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    if ready_event is not None:
        ready_event.set()
        return server
    try:
        server.serve_forever()
    finally:
        server.server_close()
