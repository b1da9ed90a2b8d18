"""Copied from ``ss_asr_tpu/utils/metrics.py`` (the metrics the ASR trainer logs).

Quality metrics: character accuracy, word-error-rate, attention maps.

Metric definitions replicate the reference exactly (src/postprocess.py:7-64):

* ``calc_acc`` — per-sample char accuracy, counting positions until the first
  pad (id 0) in the *label*; mean over batch.
* ``calc_err`` — per-sample word-level edit distance between EOS-trimmed
  translations, divided by the number of *label* words; mean over batch.
  Values can exceed 1.0 by construction.
* ``draw_att`` — attention maps stacked to 3 channels, trimmed at the
  hypothesis' first EOS.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ss_asr_tpu_torch.utils.editdistance import edit_distance
from ss_asr_tpu_torch.vocab import Mapper, trim_eos


def _to_ids(predict: np.ndarray) -> np.ndarray:
    """Accept either [B, T, C] logits or [B, T] ids."""
    predict = np.asarray(predict)
    if predict.ndim == 3:
        predict = np.argmax(predict, axis=-1)
    return predict


def calc_acc(predict: np.ndarray, label: np.ndarray) -> float:
    """Character accuracy over a batch, stopping each row at the first pad."""
    pred_ids = _to_ids(predict)
    label = np.asarray(label)
    accs: List[float] = []
    for p, l in zip(pred_ids, label):
        correct, total = 0.0, 0
        for pp, ll in zip(p, l):
            if ll == 0:
                break
            correct += int(pp == ll)
            total += 1
        if total > 0:
            accs.append(correct / total)
        else:
            accs.append(0.0)
    return float(sum(accs) / max(len(accs), 1))


def calc_err(predict: np.ndarray, label: np.ndarray, mapper: Mapper) -> float:
    """Word error rate (edit distance / label word count), mean over batch."""
    pred_ids = _to_ids(predict)
    label = np.asarray(label)
    preds = [mapper.translate(p) for p in pred_ids]
    labels = [mapper.translate(l) for l in label]
    ds = [
        float(edit_distance(p.split(" "), l.split(" "))) / len(l.split(" "))
        for p, l in zip(preds, labels)
    ]
    return float(sum(ds) / max(len(ds), 1))


def calc_cer(predict: np.ndarray, label: np.ndarray, mapper: Mapper) -> float:
    """Character error rate (edit distance / label char count), mean over batch.

    Not in the reference's metric set, but the north-star quality metric in
    BASELINE.json; provided as a first-class metric here.
    """
    pred_ids = _to_ids(predict)
    label = np.asarray(label)
    preds = [mapper.translate(p) for p in pred_ids]
    labels = [mapper.translate(l) for l in label]
    ds = [
        float(edit_distance(list(p), list(l))) / max(len(l), 1)
        for p, l in zip(preds, labels)
    ]
    return float(sum(ds) / max(len(ds), 1))


def draw_att(att_maps: np.ndarray, hyps: Sequence[Sequence[int]]) -> List[np.ndarray]:
    """Per-sample [3, decode_steps(trimmed), encode_steps] attention images."""
    att_maps = np.asarray(att_maps)
    out: List[np.ndarray] = []
    for i in range(att_maps.shape[0]):
        att_i = att_maps[i]
        att_len = len(trim_eos(hyps[i]))
        out.append(np.stack([att_i, att_i, att_i], axis=0)[:, :att_len, :])
    return out
