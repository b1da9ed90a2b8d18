"""Parameter trees as flat ``.npz`` archives.

Copied from ``ss_asr_tpu/utils/checkpoint.py`` (``save_pytree`` /
``load_pytree``, ``save_opt_state`` / ``load_opt_state``, the snapshot
helpers and ``average_pytrees``, the npz half; the orbax backend is not
ported): a nested
dict of arrays is stored with ``/``-joined tree paths as keys, so one file
is readable by both packages.  Trees hold the JAX package's layout;
``ss_asr_tpu_torch.convert`` turns them into this package's state_dicts.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, List, Tuple

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


def exists(path: str) -> bool:
    return os.path.isfile(path)


def save_opt_state(path: str, leaves: List[np.ndarray]) -> None:
    """Optimizer-state leaves as ``leaf_00000``, ``leaf_00001``, ... (the
    JAX package's ``save_opt_state`` layout, ``jax.tree.leaves`` order;
    ``convert.asr_opt_state_leaves`` gives that order)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{f"leaf_{i:05d}": np.asarray(leaf) for i, leaf in enumerate(leaves)})
    os.replace(tmp, path)


def load_opt_state(path: str) -> List[np.ndarray]:
    """The leaves ``save_opt_state`` (of either package) wrote, in order."""
    with np.load(path) as z:
        return [z[k] for k in sorted(z.files)]


def snapshot_path(ckpdir: str, module_id: str, step: int, ext: str = ".npz") -> str:
    """Step-stamped checkpoint path; zero-padded so lexical sort == step sort."""
    return os.path.join(ckpdir, f"{module_id}.snap-{step:09d}{ext}")


def list_snapshots(ckpdir: str, module_id: str) -> List[Tuple[int, str]]:
    """All snapshots of a module, as (step, path) sorted ascending by step."""
    out = []
    for p in glob.glob(os.path.join(glob.escape(ckpdir), f"{module_id}.snap-*")):
        m = re.fullmatch(rf"{re.escape(module_id)}\.snap-(\d+)\.npz", os.path.basename(p))
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def prune_snapshots(ckpdir: str, module_id: str, keep: int) -> List[str]:
    """Delete all but the ``keep`` most recent snapshots; returns removed paths."""
    removed = [p for _, p in list_snapshots(ckpdir, module_id)[: -keep or None]]
    for p in removed:
        os.remove(p)
    return removed


def average_pytrees(paths) -> Dict:
    """Elementwise mean of npz checkpoints, accumulated in float64 and cast
    back to each leaf's dtype.  Every checkpoint must have the same key set
    and leaf shapes (one training run's snapshots); a mismatch raises
    ValueError naming the leaf."""
    paths = list(paths)
    if not paths:
        raise ValueError("average_pytrees: no checkpoints given")
    acc: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, Any] = {}
    ref_keys = None
    for p in paths:
        flat = _flatten(load_pytree(p))
        if ref_keys is None:
            ref_keys = set(flat)
        elif set(flat) != ref_keys:
            diff = sorted(set(flat) ^ ref_keys)
            raise ValueError(f"average_pytrees: {p} key set differs from "
                             f"{paths[0]} (e.g. {diff[:3]})")
        for k, v in flat.items():
            v = np.asarray(v)
            if k not in acc:
                acc[k] = np.zeros(v.shape, np.float64)
                dtypes[k] = v.dtype
            elif acc[k].shape != v.shape:
                raise ValueError(f"average_pytrees: leaf {k!r} shape "
                                 f"{v.shape} in {p} != {acc[k].shape}")
            acc[k] += v.astype(np.float64)
    n = len(paths)
    return _unflatten({k: (a / n).astype(dtypes[k]) for k, a in acc.items()})
