"""Dataset index: the TSV schema shared with the preprocessing CLI.

Port of ``ss_asr_tpu/data/index.py``: tab-separated rows of
``(normalized_text, path_to_fbank, s_len, unpadded_num_frames, text_fname,
wav_fname)``, no header, sorted by frame length so that consecutive batches
have near-uniform lengths.  Read and written with ``csv`` (the JAX package
uses pandas, which the port does not need): one dict per row, the two counts
as ints.  The tools ``save_index``, ``make_split``, ``sort_index`` and
``subset_by_t`` write the same bytes as the JAX functions for the same index
and seed: the row orders below are pandas' own, rebuilt with numpy.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

import numpy as np

COLUMNS = [
    "normalized_text",
    "path_to_fbank",
    "s_len",
    "unpadded_num_frames",
    "text_fname",
    "wav_fname",
]
INT_COLUMNS = ("s_len", "unpadded_num_frames")


def load_index(path: str) -> List[Dict]:
    rows = []
    with open(path, newline="", encoding="utf-8") as f:
        for rec in csv.reader(f, delimiter="\t"):
            if not rec:
                continue
            row = dict(zip(COLUMNS, rec))
            for c in INT_COLUMNS:
                row[c] = int(row[c])
            rows.append(row)
    return rows


def save_index(rows: List[Dict], path: str) -> None:
    """Write rows as ``DataFrame.to_csv(sep="\\t", index=False,
    header=False)`` does: minimal quoting, ``\\n`` line ends."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        for row in rows:
            w.writerow([row[c] for c in COLUMNS])


def sort_order(rows: List[Dict], key: str, ascending: bool = True) -> np.ndarray:
    """The row order of pandas' ``sort_values(by=[key], ascending=...)``.

    An int column goes through numpy's default (unstable) ``argsort`` with
    pandas' reversals for a descending sort, so ties come out as pandas
    leaves them on the same numpy; a text column sorts stably both ways, as
    pandas' string arrays do, with empty fields (pandas' NaN) last."""
    if key in INT_COLUMNS:
        vals = np.array([r[key] for r in rows], dtype=np.int64)
        idx = np.arange(len(rows))
        if not ascending:
            vals, idx = vals[::-1], idx[::-1]
        order = idx[vals.argsort(kind="quicksort")]
        return order[::-1] if not ascending else order
    present = [i for i, r in enumerate(rows) if r[key] != ""]
    present.sort(key=lambda i: rows[i][key], reverse=not ascending)
    return np.array(present + [i for i, r in enumerate(rows) if r[key] == ""], dtype=np.int64)


def make_split(index: str, train_r: float = 0.9, eval_r: float = 0.1,
               seed: Optional[int] = None) -> None:
    """Random row split into train.tsv / eval.tsv beside the index: row i
    goes to train.tsv where ``default_rng(seed).random(n)[i] < train_r``."""
    assert abs(train_r + eval_r - 1.0) < 1e-9, "Ratios must sum to 1.0"
    rows = load_index(index)
    msk = np.random.default_rng(seed).random(len(rows)) < train_r
    base = os.path.dirname(index)
    save_index([r for r, m in zip(rows, msk) if m], os.path.join(base, "train.tsv"))
    save_index([r for r, m in zip(rows, msk) if not m], os.path.join(base, "eval.tsv"))


def sort_index(index: str, sort_key: str, sort_ascending: bool = True,
               out_index: Optional[str] = None) -> None:
    rows = load_index(index)
    save_index([rows[i] for i in sort_order(rows, sort_key, sort_ascending)],
               out_index if out_index is not None else index)


def subset_by_t(t: float, index: str, out_index: str, avg_utt_s: float = 4.5,
                seed: Optional[int] = None) -> None:
    """Sample a subset totalling ~t seconds of speech (low-resource setups).

    The budget is realized as a COUNT, ``int(t / avg_utt_s)`` rows, drawn as
    ``DataFrame.sample(n=num, random_state=seed)`` draws them:
    ``RandomState(seed).choice(n, num, replace=False)``, in that order."""
    rows = load_index(index)
    num = int(t / avg_utt_s)
    if num >= len(rows):
        raise ValueError(
            f"subset_by_t: {t:.0f}s at avg {avg_utt_s}s/utt needs {num} rows "
            f"but {index} holds only {len(rows)} — the requested budget is the "
            "whole corpus or more; drop the subset or lower t")
    rs = np.random.RandomState(seed) if seed is not None else np.random.mtrand._rand
    save_index([rows[i] for i in rs.choice(len(rows), size=num, replace=False)], out_index)
