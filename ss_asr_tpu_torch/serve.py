"""Dynamic-batching serving runtime over the Transcriber API.

Port of ``ss_asr_tpu/serve.py`` (``ServeStats``, ``_lattice``,
``BatchingTranscriber`` without mesh and hot reload, and ``serve_http``'s
plain path).  Concurrent requests are coalesced into one decode call; the
row count is padded up a power-of-two lattice with empty rows (their
transcripts are dropped), so a batch's shape comes from a small set.

    t = Transcriber.from_checkpoint("asr.npz", config, beam_size=1)
    with BatchingTranscriber(t, max_batch=16, max_wait_ms=5, mode="signal") as bt:
        serve_http(bt, port=8000)

``serve_http`` answers ``POST /transcribe`` (WAV body -> {"text": ...}),
``GET /healthz`` and ``GET /stats``.  The JAX server's detail / n-best /
long-form / streaming / reload routes answer 501 naming their ROADMAP.md
item.
"""

from __future__ import annotations

import io
import json
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ss_asr_tpu_torch.api import DETAIL_TODO, LONG_TODO

#: recent-window length for the percentile deques below — the exact
#: counters never truncate
STATS_WINDOW = 4096

RELOAD_TODO = "ROADMAP.md port item 5 (hot weight reload)"


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
    batch_sizes: deque = field(default_factory=lambda: deque(maxlen=STATS_WINDOW))
    wait_ms: deque = field(default_factory=lambda: deque(maxlen=STATS_WINDOW))

    def as_dict(self) -> dict:
        d = {"requests": self.requests, "batches": self.batches,
             "padded_rows": self.padded_rows}
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
def serve_http(
    batcher: BatchingTranscriber,
    host: str = "127.0.0.1",
    port: int = 8000,
    sr: Optional[int] = None,
    ready_event: Optional[threading.Event] = None,
):
    """Blocking threaded HTTP server over a BatchingTranscriber.

    POST /transcribe   body = WAV bytes -> {"text": "..."}
    GET  /healthz      -> {"ok": true}
    GET  /stats        -> batching counters (ServeStats.as_dict)

    In 'signal' mode the waveform goes to the batcher and the frontend runs
    with the batch; in 'fbank' mode each request thread computes its own
    frontend first.  Returns the server if ``ready_event`` is given (the
    caller drives ``serve_forever``); otherwise serves until interrupted.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    from ss_asr_tpu_torch.data.audio import read_wav, resample
    from ss_asr_tpu_torch.ops.frontend import compute_fbank

    if batcher.mode == "signal":
        if sr is not None and sr != batcher.sr:
            raise ValueError(f"serve_http sr={sr} != batcher sr={batcher.sr} (signal mode "
                             "decodes at the batcher's rate; pass sr= to "
                             "BatchingTranscriber instead)")
        target_sr = batcher.sr
    else:
        target_sr = sr or batcher._t.sr
    feat = batcher._t.cfg.feature_dim

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

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            elif self.path == "/stats":
                with batcher._cv:
                    d = batcher.stats.as_dict()
                self._reply(200, d)
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/reload":
                self._reply(501, {"error": f"not ported yet: {RELOAD_TODO}"})
                return
            if url.path == "/stream" or url.path.startswith("/stream/"):
                self._reply(501, {"error": f"not ported yet: {LONG_TODO}"})
                return
            if url.path != "/transcribe":
                self._reply(404, {"error": "not found"})
                return
            try:  # client-side failures: unparseable body/query -> 400
                q = parse_qs(url.query)
                n_best = int(q.get("nbest", ["1"])[0])
                detail = _flag(q, "detail")
                long_form = _flag(q, "long")
            except ValueError as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                return
            if detail or n_best > 1:
                self._reply(501, {"error": f"not ported yet: {DETAIL_TODO}"})
                return
            if long_form:
                self._reply(501, {"error": f"not ported yet: {LONG_TODO}"})
                return
            try:
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
                if batcher.mode == "signal":
                    item = y
                else:
                    item = compute_fbank(y, target_sr, n_mels=feat, device=batcher._t.device)
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
