"""Long-form transcription: windowed decode + overlap merging.

Copied from ``ss_asr_tpu/decode/longform.py`` (numpy and the standard
library only).  The LAS family decodes whole utterances; audio beyond the
trained lengths is cut into overlapping windows decoded as ONE batch, and
adjacent transcripts merge over their overlap by text agreement
(``difflib`` longest match over the overlap region).  ``energy_segments``
cuts at low-energy points instead (disjoint segments joined with a space);
``energy_cut_frame`` picks a streaming session's commit point from
per-frame levels.
"""

from __future__ import annotations

import difflib
from typing import List, Tuple

import numpy as np


def window_bounds(
    n: int, window: int, overlap: int
) -> List[Tuple[int, int]]:
    """Slice [0, n) into windows of ``window`` samples overlapping by
    ``overlap``; the last window is right-aligned so no tail is dropped."""
    if window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if not 0 <= overlap < window:
        raise ValueError(f"need 0 <= overlap < window, got {overlap}")
    if n <= window:
        return [(0, n)]
    step = window - overlap
    starts = list(range(0, n - window, step))
    starts.append(n - window)  # right-aligned final window
    return [(s, s + window) for s in starts]


def energy_segments(
    y: np.ndarray,
    sr: int,
    max_window: int,
    min_window: int,
    hop_ms: float = 10.0,
    smooth_ms: float = 50.0,
) -> List[Tuple[int, int]]:
    """Cut [0, len(y)) into disjoint segments at low-energy points.

    Each cut lands on the smoothed-RMS minimum inside
    ``[start + min_window, start + max_window]`` — in real speech that is
    a pause, so segments need no overlap and their transcripts join with
    a space (a pause is a word boundary).  Fixed-window + text-merge
    (``window_bounds``/``merge_window_texts``) remains the fallback for
    audio with no usable pauses.
    """
    n = len(y)
    if not 0 < min_window < max_window:
        raise ValueError(f"need 0 < min_window < max_window, got "
                         f"{min_window}/{max_window}")
    if n <= max_window:
        return [(0, n)]
    hop = max(1, int(sr * hop_ms / 1000.0))
    # smoothed per-hop RMS energy
    e = np.square(y.astype(np.float32))
    n_hops = n // hop
    frame_e = e[: n_hops * hop].reshape(n_hops, hop).mean(axis=1)
    k = max(1, int(smooth_ms / hop_ms))
    kernel = np.ones(k, np.float32) / k
    smooth = np.convolve(frame_e, kernel, mode="same")

    bounds: List[Tuple[int, int]] = []
    start = 0
    while n - start > max_window:
        # ceil, so lo * hop >= start + min_window: flooring could place the
        # cut at (or before) start when min_window < hop, and a
        # non-advancing cut loops forever
        lo = -((start + min_window) // -hop)
        hi = min((start + max_window) // hop, n_hops - 1)
        if hi <= lo:
            cut = start + max_window
        else:
            cut = (lo + int(np.argmin(smooth[lo:hi]))) * hop
        bounds.append((start, cut))
        start = cut
    bounds.append((start, n))
    return bounds


def energy_cut_frame(
    level: np.ndarray, lo: int, hi: int, smooth: int = 5
) -> int:
    """Pick a segment-commit point from per-frame levels.

    ``level``: any monotone per-frame loudness proxy (streaming uses the
    mean log-mel of each frontend frame — a pause is quiet in every band).
    Returns the index of the smoothed minimum inside ``[lo, hi)``; in real
    speech that is a pause, so the frames before it form a closed segment
    (same reasoning as ``energy_segments``, but over frames already paid
    for by the frontend instead of raw samples).
    """
    n = len(level)
    lo = max(0, min(lo, n))
    hi = max(lo + 1, min(hi, n))
    if hi - lo <= 1:
        return lo
    k = max(1, smooth)
    kernel = np.ones(k, np.float32)
    lv = np.asarray(level, np.float32)
    # mean over the REAL window at each position ("same" zero-padding
    # would fake quiet edges and pull cuts to the stream boundary)
    sm = np.convolve(lv, kernel, mode="same") / np.convolve(
        np.ones(n, np.float32), kernel, mode="same")
    return lo + int(np.argmin(sm[lo:hi]))


def merge_pair(prev: str, nxt: str, overlap_chars: int) -> str:
    """Join two adjacent window transcripts.

    ``overlap_chars``: how many characters of each side roughly cover the
    acoustic overlap (estimated from the windows' decoded rates).  The
    longest common block between prev's tail and nxt's head decides the
    seam; with no agreement the texts are concatenated whole (duplicates
    are preferred over dropped speech).
    """
    if not prev:
        return nxt
    if not nxt:
        return prev
    k = max(1, min(overlap_chars, len(prev), len(nxt)))
    tail = prev[-k:]
    head = nxt[:k]
    m = difflib.SequenceMatcher(a=tail, b=head, autojunk=False)
    match = m.find_longest_match(0, len(tail), 0, len(head))
    if match.size == 0:
        return prev + nxt
    # seam: keep prev up to the end of its matched block, then nxt from
    # the end of its matched block
    cut_prev = len(prev) - k + match.a + match.size
    cut_next = match.b + match.size
    return prev[:cut_prev] + nxt[cut_next:]


def merge_window_texts(texts: List[str], overlap_frac: float) -> str:
    """Fold adjacent window transcripts left to right.

    ``overlap_frac``: overlap duration / window duration; each seam's
    search region is that fraction of the neighbors' lengths (padded 2x
    for rate variation).
    """
    if overlap_frac <= 0.0:
        # disjoint windows share no audio — nothing to deduplicate, and a
        # 1-char seam search would delete real speech at every boundary
        return "".join(texts)
    out = ""
    for t in texts:
        # seam search region scales with the incoming WINDOW's text (the
        # accumulated text only ever contributes its tail)
        k = int(2 * overlap_frac * len(t)) + 1
        out = merge_pair(out, t, k)
    return out
