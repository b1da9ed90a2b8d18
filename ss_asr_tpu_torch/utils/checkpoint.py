"""Parameter trees as flat ``.npz`` archives.

Copied from ``ss_asr_tpu/utils/checkpoint.py`` (``save_pytree`` /
``load_pytree``, the npz half; the orbax backend is not ported): a nested
dict of arrays is stored with ``/``-joined tree paths as keys, so one file
is readable by both packages.  Trees hold the JAX package's layout;
``ss_asr_tpu_torch.convert`` turns them into this package's state_dicts.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_pytree(path: str, tree: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, path)


def load_pytree(path: str) -> Dict:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)
