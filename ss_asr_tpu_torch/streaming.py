"""Streaming recognition: feed waveform chunks, read partial hypotheses.

Port of ``ss_asr_tpu/streaming.py``.  A client sends audio as it is
captured and reads a transcript that firms up as it goes:

* the frontend is ``ops.frontend.StreamingFrontend`` on the transcriber's
  device: frames arrive incrementally, equal to the one-shot frontend's;
* per-update cost stays bounded for arbitrarily long streams by SEGMENT
  COMMITMENT: once the open (undecoded) span exceeds ``commit_window_s``,
  the quietest frame inside it (``decode.longform.energy_cut_frame``: a
  pause, hence a word boundary) closes the segment.  Its transcript is
  frozen, its frames are dropped, and later partials decode only the open
  tail.  The LAS decoder attends over its whole input, so within a segment
  every partial is a fresh full-context decode: partial text may be
  REVISED until its segment commits.

    st = StreamingTranscriber(transcriber)
    for chunk in microphone():
        st.feed(chunk)
        show(st.partial())      # committed + live tail
    print(st.finalize())
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ss_asr_tpu_torch.decode.longform import energy_cut_frame
from ss_asr_tpu_torch.ops.frontend import StreamingFrontend


class StreamingTranscriber:
    """One audio stream's recognition state. Not thread-safe; a server
    holds one per session (see serve.py's /stream endpoints).

    ``commit_window_s``: open-span cap — above it a segment commits at the
    quietest frame. ``min_segment_s``: no cut before this much audio, so a
    brief dip cannot shear a word. ``transcriber``: a plain single-device
    ``Transcriber`` (greedy is the sensible mode for partials; beam/LM
    settings apply to every decode including ``finalize``).
    """

    def __init__(
        self,
        transcriber,
        sr: Optional[int] = None,
        commit_window_s: float = 20.0,
        min_segment_s: float = 2.0,
        frontend_block_s: float = 0.5,
    ):
        """``frontend_block_s``: the frontend's block in seconds — also
        the partial-latency floor, since frames only emit once a full block
        of samples is buffered (StreamingFrontend clamps it up to 2
        windows)."""
        if not 0 < min_segment_s < commit_window_s:
            raise ValueError(
                f"need 0 < min_segment_s < commit_window_s, got "
                f"{min_segment_s}/{commit_window_s}"
            )
        self._t = transcriber
        self.sr = sr or transcriber.sr
        self._fe = StreamingFrontend(
            sr=self.sr,
            n_mels=transcriber.cfg.feature_dim,
            block=max(1, int(self.sr * frontend_block_s)),
            device=transcriber.device,
        )
        # frames/second of the frontend (10 ms stride => 100)
        self._fps = 1000.0 / self._fe.stride_ms
        self._max_frames = max(2, int(commit_window_s * self._fps))
        self._min_frames = max(1, int(min_segment_s * self._fps))
        self._frames = np.zeros((0, self._fe.n_mels), np.float32)
        self._committed: List[str] = []
        self._closed = False
        # partial() memo: (n_committed, n_open_frames) -> text
        self._memo_key = (-1, -1)
        self._memo_text = ""

    # ------------------------------------------------------------------
    @property
    def committed_text(self) -> str:
        """Transcript frozen so far (never revised)."""
        return " ".join(t for t in self._committed if t)

    def _decode_open(self) -> str:
        if self._frames.shape[0] == 0:
            return ""
        return self._t.transcribe_fbank([self._frames])[0]

    def _commit_until_bounded(self) -> None:
        """Close segments while the open span exceeds the window."""
        while self._frames.shape[0] > self._max_frames:
            level = self._frames.mean(axis=1)  # mean log-mel loudness
            cut = energy_cut_frame(
                level, self._min_frames, self._max_frames
            )
            seg, self._frames = self._frames[:cut], self._frames[cut:]
            self._committed.append(self._t.transcribe_fbank([seg])[0])

    # ------------------------------------------------------------------
    def feed(self, samples: np.ndarray) -> None:
        """Append waveform (float in [-1, 1], at the session's sr)."""
        if self._closed:
            raise RuntimeError("feed() after finalize()")
        out = self._fe.push(np.asarray(samples, np.float32).reshape(-1))
        if out.shape[0]:
            self._frames = np.concatenate([self._frames, out], axis=0)
        self._commit_until_bounded()

    def partial(self) -> str:
        """Committed text + a full-context decode of the open tail.

        Costs one decode per NEW state; repeated
        calls without new audio return the memoized text.
        """
        key = (len(self._committed), self._frames.shape[0])
        if key != self._memo_key:
            open_text = self._decode_open()
            parts = [t for t in self._committed if t]
            if open_text:
                parts.append(open_text)
            self._memo_text = " ".join(parts)
            self._memo_key = key
        return self._memo_text

    def finalize(self) -> str:
        """Flush the frontend (exact end padding), decode the remaining
        open span, and return the full transcript. Idempotent."""
        if not self._closed:
            out = self._fe.close()
            if out.shape[0]:
                self._frames = np.concatenate([self._frames, out], axis=0)
            self._commit_until_bounded()
            self._committed.append(self._decode_open())
            self._frames = self._frames[:0]
            self._closed = True
        return self.committed_text
