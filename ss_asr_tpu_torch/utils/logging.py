"""Copied from ``ss_asr_tpu/utils/logging.py``.

Metric logging: JSONL always; TensorBoard always (tensorboardX when
available, else the native zero-dependency tfevents writer for scalars —
utils/tfevents.py).

Mirrors the reference's ``LogHandler`` surface (src/LogHandler.py:9-30) —
``scalar`` / ``text`` / ``image`` (the ones the ASR trainer writes) with keys
prefixed ``<module_id>_`` — while guaranteeing a machine-readable JSONL
stream so observability never depends on an optional package.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

try:  # optional
    from tensorboardX import SummaryWriter
except Exception:  # pragma: no cover
    SummaryWriter = None


class MetricLogger:
    def __init__(self, logdir: str, module_id: str, use_tensorboard: bool = True):
        self.logdir = logdir
        self.module_id = module_id
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        self._native = None
        if use_tensorboard and SummaryWriter is not None:
            try:
                self._tb = SummaryWriter(logdir)
            except Exception:  # pragma: no cover
                self._tb = None
        if use_tensorboard and self._tb is None:
            # zero-dependency fallback: native tfevents writer (scalars)
            from ss_asr_tpu_torch.utils.tfevents import EventWriter

            self._native = EventWriter(logdir)

    def _key(self, key: str) -> str:
        return f"{self.module_id}_{key}"

    def _emit(self, kind: str, key: str, val: Any, step: int) -> None:
        rec = {
            "ts": time.time(),
            "kind": kind,
            "key": self._key(key),
            "step": int(step),
            "value": val,
        }
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def scalar(self, key: str, val, step: int) -> None:
        if isinstance(val, dict):
            val = {k: float(v) for k, v in val.items()}
            self._emit("scalars", key, val, step)
            if self._tb:
                self._tb.add_scalars(self._key(key), val, step)
        else:
            val = float(val)
            self._emit("scalar", key, val, step)
            if self._tb:
                self._tb.add_scalar(self._key(key), val, step)
            elif self._native:
                self._native.scalar(self._key(key), val, step)

    def text(self, key: str, val: str, step: int) -> None:
        self._emit("text", key, str(val), step)
        if self._tb:
            self._tb.add_text(self._key(key), str(val), step)

    def image(self, key: str, val, step: int) -> None:
        self._emit("image", key, f"shape={getattr(val, 'shape', None)}", step)
        if self._tb:
            self._tb.add_image(self._key(key), val, step)

    def embedding(self, key: str, val, meta, step: int) -> None:
        self._emit("embedding", key, f"n={len(meta)}", step)
        if self._tb:
            self._tb.add_embedding(val, tag=self._key(key), metadata=meta, global_step=step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb:
            self._tb.close()
        if self._native:
            self._native.close()
