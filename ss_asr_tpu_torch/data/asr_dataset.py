"""ASR dataset: index-driven batches with bucketed static shapes.

Port of ``ss_asr_tpu/data/asr_dataset.py`` with its signature (no
multi-host shards, ``host_shard`` / ``set_epoch``, which wait for ROADMAP
item 10).  ``sort_key`` reorders the index as pandas' ``sort_values`` does
(``data.index.sort_order``); ``iter_batches(shuffle=True)`` permutes the
batch starts with the JAX package's generator and seed.  ``text_only`` batches carry no fbanks but a
noised copy of the text (the text autoencoder's input): each character but
SOS and EOS is dropped with probability ``drop_rate``, drawn from
``np.random.default_rng(seed)`` in the JAX package's order, so both
packages see the same noised batch.
Batches are consecutive runs of the index; text is encoded over the fixed
vocabulary and padded with SOS (= id 0); each batch is padded to a frame
and character length rounded up to ``t_bucket`` / ``l_bucket``; lengths
follow the reference (x: the index's frame count, y: ``sum(y != 0) + 1``).
A background thread prefetches the next batches.  A trailing partial batch
is dropped (training) or padded by repeating its last row, with a
validity mask (evaluation).  Fbanks load with ``np.load`` (the JAX
package's native batch loader is its own build and is not ported).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ss_asr_tpu_torch.data.index import load_index, sort_order
from ss_asr_tpu_torch.vocab import EOS_ID, SOS_ID, Mapper


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class Batch:
    """One batch with static (bucketed) shapes."""

    x: Optional[np.ndarray]  # [B, T, feat] float32, or None (text_only)
    x_lens: Optional[np.ndarray]  # [B] int32
    y: np.ndarray  # [B, L] int32 (SOS-padded)
    y_lens: np.ndarray  # [B] int32 (sum(!=0) + 1 convention)
    y_noised: Optional[np.ndarray] = None  # [B, Ln] int32 (text_only)
    y_noised_lens: Optional[np.ndarray] = None
    valid: Optional[np.ndarray] = None  # [B] bool, False for repeat-padding


class ASRDataset:
    def __init__(self, tsv_file: str, batch_size: int = 32, text_only: bool = False,
                 drop_rate: float = 0.0, t_bucket: int = 128, l_bucket: int = 16,
                 sort_key: str = "", sort_ascending: bool = True, seed: int = 0):
        self.rows: List[Dict] = load_index(tsv_file)
        if sort_key:
            self.rows = [self.rows[i] for i in sort_order(self.rows, sort_key, sort_ascending)]
        self.batch_size = batch_size
        self.text_only = text_only
        self.drop_rate = drop_rate
        self.rng = np.random.default_rng(seed)
        self.t_bucket = t_bucket
        self.l_bucket = l_bucket
        self.mapper = Mapper()
        self.num_samples = len(self.rows)
        self.feature_dim = (int(np.load(self.rows[0]["path_to_fbank"]).shape[1])
                            if self.rows and not text_only else 0)

    def get_char_dim(self) -> int:
        return self.mapper.get_dim()

    def get_feature_dim(self) -> int:
        return self.feature_dim

    def __len__(self) -> int:
        """Number of full batches."""
        return self.num_samples // self.batch_size

    def num_batches(self, drop_last: bool = True) -> int:
        """Batch count as iter_batches will actually yield it."""
        if drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def _drop_chars(self, ids: np.ndarray) -> np.ndarray:
        """Char-drop noise; SOS and EOS are always kept."""
        if self.drop_rate <= 0:
            return ids
        keep = (ids == SOS_ID) | (ids == EOS_ID) | (
            self.rng.random(ids.shape[0]) > self.drop_rate)
        return ids[keep]

    def _encode_rows(self, rows: List[Dict], noised: bool = False) -> np.ndarray:
        enc = [self.mapper.encode(r["normalized_text"]) for r in rows]
        if noised:
            enc = [self._drop_chars(e) for e in enc]
        L = round_up(max(e.shape[0] for e in enc), self.l_bucket)
        out = np.full((len(enc), L), SOS_ID, dtype=np.int32)
        for i, e in enumerate(enc):
            out[i, : e.shape[0]] = e
        return out

    def _load_fbanks(self, rows: List[Dict]) -> Tuple[np.ndarray, np.ndarray]:
        lens = np.array([r["unpadded_num_frames"] for r in rows], dtype=np.int32)
        T = round_up(int(lens.max()), self.t_bucket)
        out = np.zeros((len(rows), T, self.feature_dim), dtype=np.float32)
        # exact-length and globally padded (reference layout) fbanks alike
        for i, r in enumerate(rows):
            fb = np.load(r["path_to_fbank"])
            n = min(int(lens[i]), fb.shape[0], T)
            out[i, :n] = fb[:n]
        return out, lens

    def get_batch(self, start: int, pad_to_full: bool = False) -> Batch:
        stop = min(start + self.batch_size, self.num_samples)
        rows = self.rows[start:stop]
        valid = None
        if pad_to_full and len(rows) < self.batch_size:
            valid = np.arange(self.batch_size) < len(rows)
            rows = rows + [self.rows[stop - 1]] * (self.batch_size - len(rows))
        y = self._encode_rows(rows)
        y_lens = ((y != 0).sum(axis=-1) + 1).astype(np.int32)
        if self.text_only:
            if self.drop_rate > 0:
                yn = self._encode_rows(rows, noised=True)
                yn_lens = ((yn != 0).sum(axis=-1) + 1).astype(np.int32)
                return Batch(None, None, y, y_lens, yn, yn_lens, valid)
            # drop_rate 0: a plain autoencoder, the "noised" input is the clean text
            return Batch(None, None, y, y_lens, y.copy(), y_lens.copy(), valid)
        x, x_lens = self._load_fbanks(rows)
        return Batch(x, x_lens, y, y_lens, valid=valid)

    def iter_batches(self, shuffle: bool = False, drop_last: bool = True, prefetch: int = 2,
                     seed: Optional[int] = None) -> Iterator[Batch]:
        """Iterate batches with background-thread prefetch, in index order or,
        with ``shuffle``, in an order drawn from ``default_rng(seed)`` (without
        a seed, from one drawn from the dataset's own generator)."""
        starts = list(range(0, self.num_samples, self.batch_size))
        if drop_last:
            starts = [s for s in starts if s + self.batch_size <= self.num_samples]
        if shuffle:
            rng = np.random.default_rng(seed if seed is not None else self.rng.integers(2**31))
            rng.shuffle(starts)
        if prefetch <= 0:
            for s in starts:
                yield self.get_batch(s, pad_to_full=not drop_last)
            return

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop_token = object()
        cancelled = threading.Event()

        def producer():
            try:
                for s in starts:
                    batch = self.get_batch(s, pad_to_full=not drop_last)
                    # a consumer that abandons the generator must not leave
                    # this thread blocked on a full queue
                    while not cancelled.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if cancelled.is_set():
                        return
                q.put(stop_token)
            except BaseException as e:  # propagate into the consumer
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop_token:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            cancelled.set()
            while not q.empty():  # unblock a producer mid-put
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def load_asr_dataset(path: str, batch_size: int = 32, text_only: bool = False,
                     drop_rate: float = 0.0, **kw) -> Tuple[Mapper, ASRDataset]:
    """Reference-parity loader: returns (Mapper, ASRDataset)."""
    ds = ASRDataset(path, batch_size, text_only=text_only, drop_rate=drop_rate, **kw)
    return ds.mapper, ds


def prepare_x(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unpadded fbank lengths recovered by counting the frames with any
    nonzero value: [B, T, F] (or the reference's [1, B, T, F]) -> (x float32,
    x_lens int32)."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 4:
        x = x[0]
    return x, (x.sum(axis=-1) != 0).sum(axis=-1).astype(np.int32)


def prepare_y(y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Text lengths under the SOS-as-pad convention, ``sum(y != 0) + 1``:
    [B, L] (or [1, B, L]) -> (y int32, y_lens int32)."""
    y = np.asarray(y, dtype=np.int32)
    if y.ndim == 3:
        y = y[0]
    return y, ((y != 0).sum(axis=-1) + 1).astype(np.int32)
