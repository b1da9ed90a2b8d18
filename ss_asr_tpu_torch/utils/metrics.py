"""Copied from ``ss_asr_tpu/utils/metrics.py`` (the metrics the ASR trainer
logs and the tester's per-row ones).

Quality metrics: character accuracy, word-error-rate, attention maps.

Metric definitions replicate the reference exactly (src/postprocess.py:7-64):

* ``calc_acc`` — per-sample char accuracy, counting positions until the first
  pad (id 0) in the *label*; mean over batch.
* ``calc_err`` — per-sample word-level edit distance between EOS-trimmed
  translations, divided by the number of *label* words; mean over batch.
  Values can exceed 1.0 by construction.
* ``draw_att`` — attention maps stacked to 3 channels, trimmed at the
  hypothesis' first EOS.
* ``char_acc_row`` / ``with_terminal_eos`` / ``err_rate`` — one decoded
  row's accuracy against its label (the emitted EOS put back), and one
  hypothesis / reference pair's word or character error.
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


def char_acc_row(pred: np.ndarray, label: np.ndarray) -> float:
    """``calc_acc`` for ONE row: positionwise match over the label's
    positions until its first pad (id 0).  Callers pass the label WITHOUT
    its leading SOS, so positions align with the decoded ids."""
    pred = np.asarray(pred)
    label = np.asarray(label)
    n = int(np.argmax(label == 0)) if (label == 0).any() else len(label)
    if n == 0:
        return 0.0
    if len(pred) < n:
        pred = np.concatenate([pred, np.zeros(n - len(pred), dtype=pred.dtype)])
    return float(np.mean(pred[:n] == label[:n]))


def with_terminal_eos(toks_row: np.ndarray, length: int) -> np.ndarray:
    """Put the emitted EOS back into a decoded row.  The decoders return the
    EOS and all after it as pad; ``length < len(toks)`` means an EOS was
    emitted at that position, ``length == len(toks)`` that the decode hit
    its step cap without one (the row is left as it is, and the label's EOS
    then counts as a miss)."""
    t = np.array(toks_row, copy=True)
    if 0 <= int(length) < len(t):
        t[int(length)] = 1  # EOS id (vocab.EOS_ID)
    return t


def err_rate(hyp: str, ref: str, unit: str = "word") -> float:
    """Edit-distance error of one hypothesis / reference pair over the
    reference's length: ``unit="word"`` the thesis' per-utterance word
    error (may exceed 1), ``unit="char"`` the per-utterance CER."""
    split = (lambda s: s.split(" ")) if unit == "word" else list
    return float(edit_distance(split(hyp), split(ref))) / max(len(split(ref)), 1)


def draw_att(att_maps: np.ndarray, hyps: Sequence[Sequence[int]]) -> List[np.ndarray]:
    """Per-sample [3, decode_steps(trimmed), encode_steps] attention images."""
    att_maps = np.asarray(att_maps)
    out: List[np.ndarray] = []
    for i in range(att_maps.shape[0]):
        att_i = att_maps[i]
        att_len = len(trim_eos(hyps[i]))
        out.append(np.stack([att_i, att_i, att_i], axis=0)[:, :att_len, :])
    return out
