"""Solver base: config handling, checkpoint / tracker / logger plumbing.

Port of ``ss_asr_tpu/train/solver.py`` for one device: per-module
checkpoint paths under ``<ckpdir>/<name>/`` (npz, in the JAX package's tree
layout, so either package resumes from the other's files), a resumable
``tracker.json``, per-module metric streams, the ``set_if_exists``
defaults, the parameter tree check on load, and the ``genpath`` in / out
checkpoint-relay helper of the trainers that share parameters.  Randomness comes from one
``torch.Generator`` seeded with ``seed + crc32(module_id) % 2**16`` (the
JAX package's key offset; the streams themselves differ from
``jax.random``'s).  A ``parallel`` section asking for more than one device
(ROADMAP item 10) and the orbax checkpoint backend (left out of the port)
raise.
"""

from __future__ import annotations

import os
import zlib
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ss_asr_tpu_torch.train.optim import Optimizer
from ss_asr_tpu_torch.utils import checkpoint as ckpt
from ss_asr_tpu_torch.utils.logging import MetricLogger
from ss_asr_tpu_torch.utils.tracker import Tracker

MULTI_DEVICE_TODO = "ROADMAP.md port item 10 (data-parallel serving and training)"


def make_optim(params, opt: dict, **kw) -> Optimizer:
    """The ``Optimizer`` an ``opt`` section asks for: its ``type`` and
    ``learning_rate``, and ``accum_steps``, ``warmup_steps``,
    ``decay_steps`` and ``end_scale`` with the JAX trainers' defaults
    (``ss_asr_tpu/train/asr_trainer.py`` passes them to ``make_optimizer``);
    ``kw``: ``mask``, ``update_scales``."""
    return Optimizer(params, opt["type"], opt["learning_rate"],
                     accum_steps=opt.get("accum_steps", 1),
                     warmup_steps=opt.get("warmup_steps", 0),
                     decay_steps=opt.get("decay_steps", 0),
                     end_scale=opt.get("end_scale", 0.0), **kw)


def joint_named_parameters(models: Dict[str, torch.nn.Module]):
    """The trainable parameters of several models under one name space:
    ``<model key>.<parameter name>``, the JAX package's joint tree paths."""
    return [(f"{key}.{n}", p) for key, m in models.items() for n, p in m.named_parameters()
            if p.requires_grad]


def make_paras(
    name: str = "experiment_1",
    logdir: str = "runs/",
    ckpdir: str = "result/",
    seed: int = 1,
    verbose: bool = True,
) -> SimpleNamespace:
    return SimpleNamespace(name=name, logdir=logdir, ckpdir=ckpdir, seed=seed, verbose=verbose)


class Solver:
    def __init__(self, config: dict, paras, module_id: str, device: str = "cuda"):
        self.config = config
        self.paras = paras
        self.module_id = module_id
        self.device = torch.device(device)

        par = config.get("parallel") or {}
        n_model, n_data = int(par.get("n_model", 1)), par.get("n_data", 1)
        if n_data in ("auto", -1):  # every visible device, as the JAX package reads it
            n_data = torch.cuda.device_count() // n_model if self.device.type == "cuda" else 1
        if (int(n_data) > 1 or n_model != 1 or par.get("host_shard") is not None
                or par.get("distributed")):
            raise NotImplementedError(f"parallel: {par} asks for more than one device; "
                                      f"see {MULTI_DEVICE_TODO}")
        if config.get("checkpoint_backend", "npz") != "npz":
            raise NotImplementedError("checkpoint_backend: the port keeps npz checkpoints; the "
                                      "orbax backend is left out of it (ROADMAP.md)")

        self.ckpdir = os.path.join(paras.ckpdir, paras.name)
        os.makedirs(self.ckpdir, exist_ok=True)
        self.tr = Tracker(os.path.join(self.ckpdir, "tracker.json"), module_id)
        self.lg = MetricLogger(os.path.join(paras.logdir, paras.name, module_id), module_id)
        self.ckppath = os.path.join(self.ckpdir, module_id + ".npz")
        self.best_ckppath = os.path.join(self.ckpdir, module_id + "_best.npz")
        self.opt_ckppath = os.path.join(self.ckpdir, module_id + "_opt.npz")

        self.keep_snapshots = int(self.set_if_exists("keep_snapshots", 0))
        self.valid_step = self.set_if_exists("valid_step", 500)
        self.logging_step = self.set_if_exists("logging_step", 250)
        self.save_step = self.set_if_exists("save_step", 1000)
        self.n_epochs = self.set_if_exists("n_epochs", 5)
        self.train_batch_size = self.set_if_exists("train_batch_size", 32)
        self.valid_batch_size = self.set_if_exists("valid_batch_size", 32)
        self.test_batch_size = self.set_if_exists("test_batch_size", 1)

        offset = zlib.crc32(module_id.encode()) % 2**16
        self.generator = torch.Generator().manual_seed(int(getattr(paras, "seed", 1)) + offset)
        self.verbose_summary()

    def set_if_exists(self, key: str, default):
        return self.config.get(self.module_id, {}).get(key, default)

    def verbose(self, msg, progress: bool = False) -> None:
        if not getattr(self.paras, "verbose", True):
            return
        if progress:
            print(str(msg) + " " * 10, end="\r")
        else:
            print(f"[INFO ({self.module_id} / {self.paras.name})] {msg}")

    def verbose_summary(self) -> None:
        self.verbose("-------SUMMARY-------")
        self.verbose(f"Current step : {self.tr.step}")
        self.verbose(f"Best metric value : {self.tr.get_best()}")
        self.verbose(f"Number of epochs: {self.n_epochs}")
        self.verbose(f"Steps: [Logging {self.logging_step}], [Saving {self.save_step}], "
                     f"[Validation {self.valid_step}]")
        self.verbose(f"Batch sizes: [Train {self.train_batch_size}], "
                     f"[Validation {self.valid_batch_size}], [Testing {self.test_batch_size}]")
        self.verbose(f"Device: {self.device}")
        self.verbose("---------------------")

    def next_seed(self) -> int:
        return int(torch.randint(2**31 - 1, (1,), generator=self.generator))

    def setup_params(self, want: Dict, init_fn, ckp_path: str) -> Dict:
        """The checkpoint at ckp_path if present, else ``init_fn(seed)``;
        both in the JAX tree layout.  A loaded tree must have the tree and
        the leaf shapes of ``want`` (the model's own tree): a checkpoint of
        another model size fails here, not deep inside the forward."""
        if not ckpt.exists(ckp_path):
            self.verbose(f"No model found at {ckp_path}. A new model will be created")
            self.loaded_ckpt = False
            return init_fn(self.next_seed())
        self.verbose(f"Loading a pretrained model from {ckp_path}")
        loaded = ckpt.load_pytree(ckp_path)
        have, exp = ({k: v.shape for k, v in ckpt._flatten(t).items()} for t in (loaded, want))
        if set(have) != set(exp):
            raise ValueError(
                f"checkpoint {ckp_path} does not match the model config (different parameter "
                "tree — wrong mdl section or a checkpoint from another model?); delete the "
                "ckpdir or fix the config")
        for k in sorted(exp):
            if have[k] != exp[k]:
                raise ValueError(
                    f"checkpoint {ckp_path} does not match the model config: leaf {k} has shape "
                    f"{have[k]}, the config expects {exp[k]}; delete the ckpdir or fix the mdl "
                    "section")
        self.loaded_ckpt = True
        return loaded

    def load_module(self, key: str, module: torch.nn.Module, init_fn, ckp_path: str):
        """``module`` on the solver's device holding the tree at ``ckp_path``
        (or ``init_fn(seed)``), converted by ``convert``'s functions for the
        model ``key``; the LSTMs' second bias stays frozen at zero, so the
        trainable leaves are the JAX package's."""
        from ss_asr_tpu_torch import convert

        sd = {k: v for k, v in module.state_dict().items() if "running_" not in k}
        tree = self.setup_params(convert.PARAMS_FROM_STATE[key](sd), init_fn, ckp_path)
        module.load_state_dict(convert.STATE_FROM_PARAMS[key](tree), strict=False)  # bias_hh = 0
        for name, p in module.named_parameters():
            p.requires_grad_("bias_hh" not in name)
        return module.to(self.device)

    def tree(self, key: str) -> Dict:
        """The JAX parameter tree of ``self.models[key]`` (numpy leaves)."""
        from ss_asr_tpu_torch import convert

        return convert.PARAMS_FROM_STATE[key](self.models[key].state_dict())

    def zero_grad(self) -> None:
        for m in self.models.values():
            m.zero_grad(set_to_none=True)

    def restore_opt(self, optim, path: str, prefixes) -> None:
        """Load ``optim``'s state over ``self.models`` from ``path`` (either
        package's file) when this run resumed from its own checkpoint."""
        from ss_asr_tpu_torch import convert

        if not (self.loaded_ckpt and ckpt.exists(path)):
            return
        self.verbose(f"Restoring optimizer state from {path}")
        if not convert.load_opt_state_leaves(optim, self.models, prefixes,
                                             ckpt.load_opt_state(path)):
            self.verbose("Optimizer state does not fit this optimizer; starting it fresh")

    def genpath(self, p, module_id: str) -> Tuple[str, str]:
        """In / out checkpoint path pair for parameter relays: None -> the
        module's own file twice, a string -> that file twice, a pair as is."""
        if p is None:
            q = os.path.join(self.ckpdir, f"{module_id}.npz")
            return (q, q)
        if isinstance(p, str):
            return (p, p)
        assert len(p) == 2
        return tuple(p)

    def save_state(self, tree: Dict, opt_leaves: Optional[List[np.ndarray]] = None) -> None:
        """Save params (and optimizer leaves) to the default paths; with
        ``keep_snapshots: K`` also a step-stamped snapshot, pruned to the K
        most recent."""
        ckpt.save_pytree(self.ckppath, tree)
        if opt_leaves is not None:
            ckpt.save_opt_state(self.opt_ckppath, opt_leaves)
        if self.keep_snapshots > 0:
            ckpt.save_pytree(ckpt.snapshot_path(self.ckpdir, self.module_id, self.tr.step), tree)
            ckpt.prune_snapshots(self.ckpdir, self.module_id, self.keep_snapshots)

    def close(self) -> None:
        return None
