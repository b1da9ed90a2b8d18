"""Char-LM dataset: a text corpus sliced into fixed-size chunks.

Copied from ``ss_asr_tpu/data/lm_dataset.py`` (numpy only).  Chunk ``i``
starts at character ``i * chunk_size`` (the reference indexes it at ``i``,
so only the first ``len(file) / chunk_size`` characters ever start a chunk;
non-overlapping consecutive chunks are the evident intent).  Batches are
``(x, y)`` int32 arrays of shape [B, chunk_size] with ``y`` one character
ahead of ``x``; characters outside the vocabulary (newlines, say) become
UNK.  ``host_shard`` takes a strided share of the chunks per process,
truncated to equal size, and ``set_epoch`` rotates both the share and the
truncation window.  ``load_lm_dataset`` and ``make_split`` keep the JAX
package's surface for its callers; the trainer builds ``LMDataset`` itself.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from ss_asr_tpu_torch.vocab import UNK_ID, Mapper


class LMDataset:
    def __init__(
        self,
        filename: Optional[str] = None,
        chunk_size: int = 200,
        text: Optional[str] = None,
        host_shard: Optional[Tuple[int, int]] = None,
    ):
        self.mapper = Mapper()
        if text is None and filename is not None:
            with open(filename, "r", encoding="utf-8") as f:
                text = f.read()
        self.text = text or ""
        self.chunk_size = chunk_size
        self.ids = np.array([self.mapper.mapping.get(c, UNK_ID) for c in self.text],
                            dtype=np.int32)
        self._n_total = max(0, (len(self.ids) - 1) // self.chunk_size)
        self.host_shard = host_shard
        self._shard(0)

    def _shard(self, epoch: int) -> None:
        if self.host_shard is not None:
            # strided per-process shares truncated to equal size; the strided
            # list is rolled by the epoch before truncation, so no chunk is
            # stranded in the truncated tail forever
            host_id, num_hosts = self.host_shard
            per = self._n_total // num_hosts
            offset = (host_id + epoch) % num_hosts
            strided = np.arange(self._n_total)[offset::num_hosts]
            self.chunk_ids = np.roll(strided, -epoch)[:per]
        else:
            self.chunk_ids = np.arange(self._n_total)

    def set_epoch(self, epoch: int) -> None:
        """Rotate the shard offset and the truncation window for ``epoch``."""
        self._shard(epoch)

    def get_num_chars(self) -> int:
        return self.mapper.get_dim()

    def __len__(self) -> int:
        """Number of full chunks (a chunk consumes chunk_size + 1 chars)."""
        return len(self.chunk_ids)

    def get_chunk(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        s = i * self.chunk_size
        chunk = self.ids[s : s + self.chunk_size + 1]
        return chunk[:-1], chunk[1:]

    def iter_batches(
        self, batch_size: int, shuffle: bool = True, seed: int = 0
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields (x, y) [B, chunk_size] batches; drops the last partial."""
        order = self.chunk_ids.copy()
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for b in range(len(self) // batch_size):
            idx = order[b * batch_size : (b + 1) * batch_size]
            xs, ys = zip(*(self.get_chunk(int(i)) for i in idx))
            yield np.stack(xs), np.stack(ys)


def load_lm_dataset(filename: str, chunk_size: int, batch_size: int, **kw) -> LMDataset:
    """The JAX package's loader, signature included: ``batch_size`` and
    ``kw`` are unused there too (``iter_batches`` takes the batch size)."""
    return LMDataset(filename, chunk_size)


def make_split(filename: str, train_file: str, eval_file: str, split: float = 0.9) -> None:
    """Character-level split of a corpus file: the first ``split`` of it to
    ``train_file``, the rest to ``eval_file``."""
    with open(filename, "r", encoding="utf-8") as f:
        text = f.read()
    train_len = int(split * len(text))
    with open(train_file, "w", encoding="utf-8") as t:
        t.write(text[:train_len])
    with open(eval_file, "w", encoding="utf-8") as e:
        e.write(text[train_len:])
