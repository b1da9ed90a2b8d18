"""Device mesh, batch sharding, and the collectives of data parallelism.

Port of ``ss_asr_tpu/parallel/mesh.py``'s data axis.  The JAX package gets
data parallelism from one SPMD program (``shard_map`` inside ``jit``, a
``pmean`` over the ``data`` axis).  The port takes PyTorch's idiom, one
process per device under ``torch.distributed``: every rank holds a replica
of the parameters and the optimizer, runs the forward and backward on its
own rows, and ``average_gradients`` makes ONE flat all-reduce that averages
every parameter's gradient (and the loss) over the ranks before the
unchanged ``Optimizer.step()``.  That keeps the JAX order (pmean, then
``apply_if_finite`` / ``MultiSteps`` on the averaged gradients), so every
rank takes the same NaN-skip and accumulation decisions and the replicas
stay bit-equal; ``broadcast_`` copies rank 0's state over the others once,
after the models are built.

In one process a ``Mesh`` serves rows over several devices
(``api.Transcriber(mesh=)``): the rows split over the data axis and each
shard decodes on its device.

Tensor parallelism (``param_pspec``, ``param_shardings``, ``shard_params``;
``n_model`` > 1) is left out of the port: ``make_mesh`` and the solver
raise ``NotImplementedError`` for it.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
TP_LEFT_OUT = ("tensor parallelism (n_model > 1) is left out of the port: ROADMAP.md, "
               "'Leave out of the port'")
LAUNCH = "python -m torch.distributed.run --nproc-per-node {n} -m ss_asr_tpu_torch.cli.train ..."


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A one-axis mesh: the ``data`` axis as a tuple of ``torch.device``.

    A device may repeat.  That is how the tests split rows over several
    "devices" on the CPU (``["cpu"] * 8``) and over two on one GPU
    (``["cuda:0", "cuda:0"]``), as the JAX package's tests do with
    ``--xla_force_host_platform_device_count``."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...] = (DATA_AXIS,)):
        self.devices = tuple(_device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != 1 or not self.devices:
            raise ValueError(f"a Mesh has one axis and at least one device, got "
                             f"{self.axis_names} over {len(self.devices)} devices")

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis_names={self.axis_names})"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``data`` mesh over the first ``n_data`` of ``devices`` (default:
    every visible CUDA device, all of them)."""
    if n_model != 1:
        raise NotImplementedError(TP_LEFT_OUT)
    if devices is None:
        if torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= (a repeated "
                               "device splits rows on one device, e.g. ['cpu'] * 8)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n_data = len(devices) if n_data is None else int(n_data)
    if not 1 <= n_data <= len(devices):
        raise ValueError(f"mesh {n_data}x{n_model} > {len(devices)} devices")
    return Mesh(devices[:n_data])


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def shard_batch(tree, mesh: Mesh) -> list:
    """Every array of ``tree`` split by rows over the data axis: one tree
    per mesh position, its arrays (tensors) on that position's device.  The
    batch must divide the axis (``pad_batch_to``)."""
    B, n = int(_leaves(tree)[0].shape[0]), len(mesh.devices)
    if B % n:
        raise ValueError(f"shard_batch: {B} rows do not divide over the {n}-device data axis")
    b = B // n

    def rows(x, i, d):
        x = x[i * b:(i + 1) * b]
        return (x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))).to(d)

    return [_tree_map(lambda x, i=i, d=d: rows(x, i, d), tree)
            for i, d in enumerate(mesh.devices)]


def pad_batch_to(tree, batch: int):
    """Copied from the JAX package: pad every array's leading dim up to
    ``batch`` by repeating its last row, so that the global batch divides
    the data axis -> (tree, n_valid)."""

    def pad(x):
        x = np.asarray(x)
        if x.shape[0] >= batch:
            return x[:batch]
        reps = np.repeat(x[-1:], batch - x.shape[0], axis=0)
        return np.concatenate([x, reps], axis=0)

    n_valid = min(batch, _leaves(tree)[0].shape[0])
    return _tree_map(pad, tree), n_valid


# ----------------------------------------------------------------------
# processes: one rank per device, under torch.distributed


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def init_process_group(device="cuda") -> torch.device:
    """Bring up ``torch.distributed`` from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) -> this rank's device.

    A CUDA rank takes ``cuda:(LOCAL_RANK % device_count)``; the backend is
    NCCL where every rank of the host has a card of its own, and gloo where
    ranks share one (NCCL refuses two ranks on one card).  A CPU device (the
    caller asks for it) takes gloo.  Nothing falls back to the CPU."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"parallel: {{distributed: true}} reads torchrun's environment, which "
                           f"lacks {missing}: launch with {LAUNCH}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = torch.device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(f"rank {rank}: device {device} asked for, but no CUDA device is "
                               "visible")
        dev = torch.device("cuda", local_rank % n)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_world <= n else "gloo"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            rank=rank, world_size=world)
    return dev


def _scalar_device(device) -> torch.device:
    """Where a collective's host-side scalar lives: the card under NCCL, the
    CPU under gloo."""
    return torch.device(device) if dist.get_backend() == "nccl" else torch.device("cpu")


def all_reduce_int(value: int, op: str, device) -> int:
    """``value`` reduced over the ranks by ``op`` ("min" or "max")."""
    t = torch.tensor([int(value)], dtype=torch.int64, device=_scalar_device(device))
    dist.all_reduce(t, op={"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}[op])
    return int(t)


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def average_gradients(params: Iterable[torch.Tensor],
                      extras: Sequence[torch.Tensor] = ()) -> List[torch.Tensor]:
    """ONE flat all-reduce that averages over the ranks every parameter's
    ``.grad`` (a ``None`` gradient taken as zeros, so that every rank
    reduces the same list) and each of ``extras`` (the loss; the SAE's new
    batch-norm statistics).  The averaged gradients are written back to
    ``.grad``; returns the averaged extras."""
    params = list(params)
    parts = [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
             for p in params] + [e.detach().reshape(-1) for e in extras]
    flat = torch.cat(parts)
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    out, o = [], 0
    for t in params + list(extras):
        out.append(flat[o:o + t.numel()].view(t.shape))
        o += t.numel()
    for p, g in zip(params, out):
        p.grad = g
    return out[len(params):]


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s values: one flat
    broadcast per (dtype, device)."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src)
        o = 0
        with torch.no_grad():
            for t in ts:
                t.copy_(flat[o:o + t.numel()].view(t.shape))
                o += t.numel()
