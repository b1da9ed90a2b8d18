"""Rank processes of the port's tensor-parallel tests (test_torch_tp.py).

The ranks start as ``torch_dp_workers.run_ranks`` starts them (spawn, one
torch thread, a gloo group on a free local port, joined within
RANK_TIMEOUT_S).  A rank of a ``(n_data, n_model)`` mesh takes the rows of
its data index ``rank // n_model``.  The functions below import torch and
the port only: a spawned rank imports no JAX.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.distributed

from torch_dp_workers import _paras, asr_loops, launches


def _rows(a, d, n_data, dev):
    b = a.shape[0] // n_data
    return torch.from_numpy(np.ascontiguousarray(a[d * b:(d + 1) * b])).to(dev)


def tp_steps(rank, world, dev, cases):
    """Each case: ``(config, tmp, name, [(x, x_lens, y) global batches])``;
    the trainer starts from ``<tmp>/result/<name>/asr.npz`` and steps on
    its data index's rows of each batch -> per case: the losses, the
    gathered parameter tree, the optimizer's leaves gathered to full width,
    this rank's optimizer tensors (shards and replicated leaves, by name),
    which of them are shards, the mesh coordinates, the host shard, the
    bytes gathered and reduced, the backend and device, and the kernels'
    launches."""
    from ss_asr_tpu_torch import convert
    from ss_asr_tpu_torch.train.asr_trainer import ASRTrainer

    out = []
    for config, tmp, name, batches in cases:
        t = ASRTrainer(copy.deepcopy(config), _paras(tmp, name), device=str(dev))
        t.set_model()
        d, n = t.data_index, t.n_data
        before = launches()
        losses = [float(t.step(_rows(x, d, n, dev), _rows(xl, d, n, dev),
                               _rows(y, d, n, dev).long())[0])
                  for x, xl, y in batches]
        after = launches()
        full = t.tp_gathered(t.model, t.optim)
        out.append({
            "losses": losses, "tree": t.params_tree(),
            "opt": convert.asr_opt_state_leaves(full, t.model),
            "local": {k: p.detach().cpu().numpy().copy() for k, p in t.optim.params.items()},
            "shards": sorted(t.optim.shards), "coords": (t.tp.d, t.tp.m),
            "host_shard": t.host_shard, "bytes": dict(t.tp.bytes),
            "backend": torch.distributed.get_backend(), "device": str(dev),
            "launches": {k: after[k] - before[k] for k in after}})
    return out


def refusals(rank, world, dev, tmp, config):
    """The TAE, SAE, ADV and char-LM trainers under ``n_model`` > 1 -> the
    type and message of what each ``set_model`` raised."""
    from ss_asr_tpu_torch.train.adv_trainer import ADVTrainer
    from ss_asr_tpu_torch.train.lm_trainer import CHARLMTrainer
    from ss_asr_tpu_torch.train.sae_trainer import SAETrainer
    from ss_asr_tpu_torch.train.tae_trainer import TAETrainer

    out = {}
    for kind, cls in (("tae", TAETrainer), ("sae", SAETrainer), ("adv", ADVTrainer),
                      ("char_lm", CHARLMTrainer)):
        t = cls(copy.deepcopy(config), _paras(tmp, f"refuse_{kind}"), device=str(dev))
        t.load_data()
        try:
            t.set_model()
            out[kind] = None
        except AssertionError as e:
            out[kind] = (type(e).__name__, str(e))
    return out


def tp_run(rank, world, dev, cases, tmp, loop_configs, aux_config):
    """Everything the (2, 2) tests ask of the ranks, in one start-up: the
    step cases, the trainer loops (``asr_loops``), the refusals."""
    return {"steps": tp_steps(rank, world, dev, cases),
            "loops": asr_loops(rank, world, dev, tmp, loop_configs),
            "refusals": refusals(rank, world, dev, tmp, aux_config)}
