"""Training progress tracker persisted to ``tracker.json``.

Copied from ``ss_asr_tpu/utils/tracker.py``.

Same on-disk schema as the reference (src/TrackerHandler.py): one JSON object
mapping ``module_id -> {"best": float, "step": int}``, rewritten on every
mutation so a killed run can resume at its exact step.
"""

from __future__ import annotations

import json
import os


class Tracker:
    def __init__(self, path: str, module_id: str, default_best: float = 10000.0,
                 writer: bool = True):
        """``writer=False`` keeps the in-memory state in sync but never
        touches the file — multi-host runs pass writer only to process 0 so
        N processes sharing one ckpdir don't race on tracker.json."""
        self.path = path
        self.module_id = module_id
        self.writer = bool(writer)
        if not os.path.exists(self.path):
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            if self.writer:
                # atomic create: a concurrent reader on a shared ckpdir must
                # never observe a half-written (empty) tracker.json
                tmp = self.path + ".tmp"
                with open(tmp, "w") as f:
                    f.write("{}")
                os.replace(tmp, self.path)
        if os.path.exists(self.path):
            with open(self.path, "r") as f:
                self.data = json.load(f)
        else:
            self.data = {}
        if self.module_id not in self.data:
            self.data[self.module_id] = {"best": default_best, "step": 0}
        self.step = int(self.data[self.module_id]["step"])

    def do_step(self, n: int = 1) -> None:
        self.data[self.module_id]["step"] += n
        self.step += n
        self._save()

    def get_best(self) -> float:
        return self.data[self.module_id]["best"]

    def set_best(self, val: float) -> None:
        self.data[self.module_id]["best"] = float(val)
        self._save()

    def _save(self) -> None:
        if not self.writer:
            return
        # atomic replace so a killed run can never leave a torn tracker.json
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.data, f)
        os.replace(tmp, self.path)
