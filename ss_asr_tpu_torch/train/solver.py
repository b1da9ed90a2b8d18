"""Solver base: config handling, checkpoint / tracker / logger plumbing.

Port of ``ss_asr_tpu/train/solver.py``: per-module checkpoint paths under
``<ckpdir>/<name>/`` (npz, in the JAX package's tree layout, so either
package resumes from the other's files), a resumable ``tracker.json``,
per-module metric streams, the ``set_if_exists`` defaults, the parameter
tree check on load, and the ``genpath`` in / out checkpoint-relay helper of
the trainers that share parameters.  Randomness comes from one
``torch.Generator`` seeded with ``seed + crc32(module_id) % 2**16`` (the
JAX package's key offset; the streams themselves differ from
``jax.random``'s).  The orbax checkpoint backend is left out of the port
and raises.

Data parallelism (``parallel: {n_data: N | auto}``, N ranks launched by
``torchrun``, ``parallel/mesh.py``): each rank reads a strided shard of the
training index (``host_shard``) and holds its own rows; a train step
averages the gradients and the loss over the ranks in one all-reduce
(``dp_average``) before the optimizer's step; the random draws of a step
are those of the GLOBAL batch, from the same generator on every rank, each
rank keeping its own rows (``global_rows``), so that a step equals one
process on the joined batch and the ranks' generators stay in lockstep.
Rank 0 alone writes ``tracker.json`` and the checkpoints, with a barrier
after each write; the other ranks log under ``rank{r}``.  ``n_data: 1`` (or
no section) is the single-process path, unchanged.

Tensor parallelism (``parallel: {n_data: D, n_model: M}``, D x M ranks, the
ASR trainer; the others refuse it, as the JAX package's do): rank r sits at
data index ``d = r // M`` (its rows: ``host_shard = (d, D)`` and the global
batch's rows of ``d``) and model index ``r % M``.  ``place_tp`` cuts the
optimizer to the rank's shards (``parallel/mesh.py``); a step's full
gradient is cut to them (``tp_grads``), averaged over the data group, and
after the update the model's full weights are gathered from the shards
(``tp_sync``), so the kernels, ``valid()`` and the checkpoints read full
weights.  A save gathers the optimizer's slots to full width
(``tp_gathered``, collective); rank 0 writes, in the JAX package's layout.
"""

from __future__ import annotations

import os
import zlib
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ss_asr_tpu_torch.parallel import mesh as pmesh
from ss_asr_tpu_torch.train.optim import Optimizer
from ss_asr_tpu_torch.utils import checkpoint as ckpt
from ss_asr_tpu_torch.utils.logging import MetricLogger
from ss_asr_tpu_torch.utils.tracker import Tracker


def make_solver_mesh(config: dict, device) -> Optional[pmesh.Mesh]:
    """The mesh the ``parallel`` section asks for, over the ranks' devices;
    None for one rank (``n_data: 1``, the default, or no section).
    ``n_data: auto`` is the number of ranks divided by ``n_model``; the mesh
    must hold every rank: in a single process a larger mesh raises, saying to
    launch that many ranks."""
    par = config.get("parallel") or {}
    n_model = int(par.get("n_model", 1))
    world = pmesh.process_count()
    n_data = par.get("n_data", 1)
    n_data = max(world // n_model, 1) if n_data in ("auto", -1) else int(n_data)
    n = n_data * n_model
    if n != world:
        if world == 1:
            what = (f"n_data {n_data}" if n_model == 1 else
                    f"n_data {n_data} x n_model {n_model}")
            raise ValueError(f"parallel: {what} asks for {n} ranks, but this process runs "
                             f"alone: launch {n} ranks, {pmesh.LAUNCH.format(n=n)}, with "
                             "parallel: {distributed: true}")
        raise ValueError(f"parallel: n_data {n_data} x n_model {n_model} under {world} ranks: "
                         f"set n_data: auto or {world // n_model}")
    if world == 1:
        return None
    import torch.distributed as dist

    devices = [None] * world
    dist.all_gather_object(devices, str(device))
    return pmesh.make_mesh(n_data, n_model, devices)


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

        if config.get("checkpoint_backend", "npz") != "npz":
            raise NotImplementedError("checkpoint_backend: the port keeps npz checkpoints; the "
                                      "orbax backend is left out of it (ROADMAP.md)")
        self.mesh = make_solver_mesh(config, self.device)
        self.rank = pmesh.process_index()
        self.n_model = int((config.get("parallel") or {}).get("n_model", 1))
        self.data_index = self.rank // self.n_model
        self.tp = pmesh.TensorParallel(self.mesh, self.rank) if self.n_model > 1 else None
        hs = (config.get("parallel") or {}).get("host_shard")
        if hs is not None:  # a rank's shard by hand: how one process exercises the path
            self.host_shard: Optional[Tuple[int, int]] = (int(hs[0]), int(hs[1]))
        elif self.mesh is not None:
            self.host_shard = (self.data_index, self.n_data)
        else:
            self.host_shard = None

        self.ckpdir = os.path.join(paras.ckpdir, paras.name)
        os.makedirs(self.ckpdir, exist_ok=True)
        # rank 0 alone writes tracker.json and the checkpoints: ranks sharing one ckpdir
        # must not race on the same files (each keeps the state in memory)
        self.is_writer = self.rank == 0
        self.tr = Tracker(os.path.join(self.ckpdir, "tracker.json"), module_id,
                          writer=self.is_writer)
        log_dir = os.path.join(paras.logdir, paras.name, module_id)
        if not self.is_writer:
            log_dir = os.path.join(log_dir, f"rank{self.rank}")
        self.lg = MetricLogger(log_dir, module_id)
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
        if self.mesh is not None:
            import torch.distributed as dist

            self.verbose(f"Parallel: rank {self.rank} of {len(self.mesh.devices)} "
                         f"({dist.get_backend()}), mesh {self.mesh.shape}, devices "
                         f"{[str(d) for d in self.mesh.devices]}")
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

    def save_tree(self, path: str, tree: Dict) -> None:
        """Rank 0 writes the parameter tree; every rank waits at a barrier
        after it, so that no rank reads a checkpoint before it is whole
        (the Seed chain's relays)."""
        if self.is_writer:
            ckpt.save_pytree(path, tree)
        pmesh.barrier()

    def save_opt(self, path: str, leaves: List[np.ndarray]) -> None:
        """Rank 0 writes the optimizer's leaves, then a barrier (as ``save_tree``)."""
        if self.is_writer:
            ckpt.save_opt_state(path, leaves)
        pmesh.barrier()

    def save_state(self, tree: Dict, opt_leaves: Optional[List[np.ndarray]] = None) -> None:
        """Save params (and optimizer leaves) to the default paths; with
        ``keep_snapshots: K`` also a step-stamped snapshot, pruned to the K
        most recent."""
        self.save_tree(self.ckppath, tree)
        if opt_leaves is not None:
            self.save_opt(self.opt_ckppath, opt_leaves)
        if self.keep_snapshots > 0:
            self.save_tree(ckpt.snapshot_path(self.ckpdir, self.module_id, self.tr.step), tree)
            if self.is_writer:
                ckpt.prune_snapshots(self.ckpdir, self.module_id, self.keep_snapshots)

    # -- data parallelism (parallel/mesh.py); each a no-op for one rank -----
    @property
    def n_data(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[pmesh.DATA_AXIS]

    def broadcast_state(self, modules, optims) -> None:
        """Rank 0's parameters, buffers and optimizer slots over every rank's,
        once the models are built (every rank starts from the same seed or
        file; this makes sure)."""
        if self.mesh is None:
            return
        ts = [t for m in modules for t in list(m.parameters()) + list(m.buffers())
              if t.is_floating_point()]
        for o in optims:
            ts += [t for slot in o.state.values() for t in slot.values()]
            ts += list(o.acc_grads.values())
        pmesh.broadcast_(ts)

    def dp_average(self, params, *extras):
        """The data-parallel step's one all-reduce: every gradient of
        ``params`` (in place) and each of ``extras`` averaged over the ranks,
        under tensor parallelism over the data group -> the averaged extras;
        unchanged for one data index."""
        if self.n_data == 1:
            return extras
        if self.tp is None:
            return tuple(pmesh.average_gradients(params, extras))
        params = list(params)
        self.tp.bytes["reduce"] += 4 * sum(t.numel() for t in params + list(extras))
        return tuple(pmesh.average_gradients(params, extras, self.tp.data_group))

    def global_rows(self, B: int) -> Tuple[int, Optional[slice]]:
        """(the global batch, this rank's rows of it) for a local batch of
        ``B`` rows: the random draws are drawn for the global batch and
        each rank keeps its rows; (B, None) for one rank."""
        if self.mesh is None:
            return B, None
        return B * self.n_data, slice(self.data_index * B, (self.data_index + 1) * B)

    def global_width(self, n: int) -> int:
        """The largest ``n`` over the ranks (a step's decode length, which
        sets how many draws it takes)."""
        if self.mesh is None:
            return n
        return pmesh.all_reduce_int(n, "max", self.device)

    def improved(self, value: float) -> bool:
        """Whether a validation value beats the best so far, decided alike on
        every rank (each validates the whole corpus; the save that follows
        holds a barrier)."""
        better = value < self.tr.get_best()
        if self.mesh is None:
            return better
        return bool(pmesh.all_reduce_int(int(better), "max", self.device))

    def global_min_batches(self, n: int) -> int:
        """The number of train steps EVERY rank can take this epoch: strided
        shards can differ by a row and pack into different batch counts, and
        a rank entering an all-reduce the others never reach would hang."""
        if self.mesh is None:
            return n
        m = pmesh.all_reduce_int(n, "min", self.device)
        if m < n:  # these batches rotate with set_epoch: no row is skipped forever
            self.verbose(f"data-parallel step cap: skipping {n - m} of {n} local batches this "
                         "epoch (other ranks have fewer)")
        return m

    # -- tensor parallelism (parallel/mesh.py; the ASR trainer) ---------------
    def refuse_tp(self) -> None:
        """The JAX package's refusal, for the trainers of the small models."""
        if self.n_model != 1:
            raise AssertionError("parallel.n_model > 1 (tensor parallelism) is supported by the "
                                 "ASR trainer; this model is too small to shard")

    def place_tp(self, model: torch.nn.Module, optim: Optimizer) -> Optimizer:
        """``optim`` over this rank's shards of ``model``'s sharded parameters
        (``param_shardings``) and over the replicated ones as they are, its
        slots and running means cut the same way.  The model keeps the full
        weights that the kernels read."""
        specs = pmesh.param_shardings(model.state_dict(), self.mesh)
        self.tp_specs = {k: specs[k] for k in optim.params if specs[k]}

        def cut(k, t):
            return self.tp.local(t, self.tp_specs[k]).clone() if k in self.tp_specs else t

        params = {k: cut(k, p.detach()) if k in self.tp_specs else p
                  for k, p in optim.params.items()}
        return optim.with_state(cut, params, self.tp.model_group)

    def tp_grads(self, model: torch.nn.Module, optim: Optimizer) -> None:
        """Each shard's gradient: its slice of the backward's full gradient
        (the same on every model rank, which ran the same rows)."""
        named = dict(model.named_parameters())
        for k, spec in self.tp_specs.items():
            g = named[k].grad
            optim.params[k].grad = None if g is None else self.tp.local(g, spec).contiguous()
            named[k].grad = None

    def tp_sync(self, model: torch.nn.Module, optim: Optimizer) -> None:
        """The model's full weights gathered from the updated shards."""
        named = dict(model.named_parameters())
        self.tp.gather_([(optim.params[k], named[k], spec) for k, spec in self.tp_specs.items()])

    def tp_gathered(self, model: torch.nn.Module, optim: Optimizer) -> Optimizer:
        """``optim`` with its slots and running means gathered to full width
        (a collective: every rank calls it), for a checkpoint."""
        named = dict(model.named_parameters())
        pairs = [(t, torch.empty_like(named[k]), self.tp_specs[k])
                 for d in list(optim.state.values()) + [optim.acc_grads]
                 for k, t in d.items() if k in self.tp_specs]
        if pairs:  # SGD without accumulation keeps no slot
            self.tp.gather_(pairs)
        full = {id(t): f for t, f, _ in pairs}
        return optim.with_state(lambda k, t: full.get(id(t), t))

    def close(self) -> None:
        return None
