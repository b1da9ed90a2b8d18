"""Dataset index: the TSV schema shared with the preprocessing CLI.

Port of ``ss_asr_tpu/data/index.py`` ``load_index``: tab-separated rows of
``(normalized_text, path_to_fbank, s_len, unpadded_num_frames, text_fname,
wav_fname)``, no header, sorted by frame length so that consecutive batches
have near-uniform lengths.  Read with ``csv`` (the JAX package reads it with
pandas, which the port does not need): one dict per row, the two counts as
ints.
"""

from __future__ import annotations

import csv
from typing import Dict, List

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
