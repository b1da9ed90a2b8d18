"""Device mesh, sharding rules, and the collectives of data and tensor
parallelism.

Port of ``ss_asr_tpu/parallel/mesh.py``.  The JAX package gets both axes
from one SPMD program (``shard_map`` or GSPMD inside ``jit``).  The port
takes PyTorch's idiom, one process per device under ``torch.distributed``.

* **Data** (``n_data``): every rank holds a replica of the parameters and
  the optimizer, runs the forward and backward on its own rows, and
  ``average_gradients`` makes ONE flat all-reduce that averages every
  parameter's gradient (and the loss) over the ranks before the unchanged
  ``Optimizer.step()``.  That keeps the JAX order (pmean, then
  ``apply_if_finite`` / ``MultiSteps`` on the averaged gradients), so every
  rank takes the same NaN-skip and accumulation decisions and the replicas
  stay bit-equal; ``broadcast_`` copies rank 0's state over the others once,
  after the models are built.
* **Model** (``n_model`` > 1, the ASR trainer): ``n_data x n_model`` ranks
  laid out as JAX's ``devices.reshape(n_data, n_model)``, rank r at data
  index ``r // n_model`` and model index ``r % n_model``.  Each leaf that
  ``param_pspec`` shards (read on the JAX layout's shape, through
  ``convert.asr_leaf_layout``) is held, with its optimizer slots, as the
  rank's slice only (``shard_params``); the others are replicated.  The
  kernels run on full weights over the model group's rows, as the JAX
  package's ``batch_partitioned`` rules make GSPMD all-gather them
  (``ops/pallas/partition.py``): ``TensorParallel.gather_`` writes the full
  weights from the group's shards in one flat all-reduce, the backward's full
  gradient (bit-equal on every model rank, which ran the same rows) is cut to
  the rank's slice, the slices average over the data group, and the
  optimizer updates them.  The matmuls outside the kernels (the listener's
  input projections, ``psi``) also run on the gathered weights: at the
  flagship width their column-parallel form would all-gather about 250 MB of
  gate activations a step, where the weights are about 40 MB.

In one process a ``Mesh`` serves rows over several devices
(``api.Transcriber(mesh=)``): the rows split over the data axis and each
shard decodes on its device.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
LAUNCH = "python -m torch.distributed.run --nproc-per-node {n} -m ss_asr_tpu_torch.cli.train ..."


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A mesh of ``torch.device``s: one axis, a flat sequence, or two, a
    sequence of rows (``[[d00, d01], [d10, d11]]`` over ``("data",
    "model")``, JAX's device array).  ``devices`` is the flat tuple in rank
    order, row-major.

    A device may repeat.  That is how the tests split rows over several
    "devices" on the CPU (``["cpu"] * 8``) and over two on one GPU
    (``["cuda:0", "cuda:0"]``), as the JAX package's tests do with
    ``--xla_force_host_platform_device_count``."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...] = (DATA_AXIS,)):
        self.axis_names = tuple(axis_names)
        rows = [list(r) for r in devices] if len(self.axis_names) == 2 else [list(devices)]
        if (len(self.axis_names) not in (1, 2) or not rows or not rows[0]
                or any(len(r) != len(rows[0]) for r in rows)):
            raise ValueError(f"a Mesh has one or two axes over a full grid of devices, got "
                             f"{self.axis_names} over {devices}")
        self.devices = tuple(_device(d) for r in rows for d in r)
        sizes = (len(rows), len(rows[0])) if len(self.axis_names) == 2 else (len(rows[0]),)
        self.shape = dict(zip(self.axis_names, sizes))

    @property
    def data_devices(self) -> tuple:
        """One device per data index (model index 0): where rows go."""
        return self.devices[::self.shape.get(MODEL_AXIS, 1)]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, shape={self.shape})"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``data`` mesh over the first ``n_data`` of ``devices`` (default:
    every visible CUDA device, divided by ``n_model``), or with ``n_model``
    > 1 a ``(data, model)`` mesh over the first ``n_data * n_model``, laid
    out as JAX's ``devices.reshape(n_data, n_model)``."""
    if devices is None:
        if torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= (a repeated "
                               "device splits rows on one device, e.g. ['cpu'] * 8)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices, n_model = list(devices), int(n_model)
    n_data = len(devices) // max(n_model, 1) if n_data is None else int(n_data)
    if n_model < 1 or n_data < 1 or n_data * n_model > len(devices):
        raise ValueError(f"mesh {n_data}x{n_model} > {len(devices)} devices")
    if n_model == 1:
        return Mesh(devices[:n_data])
    return Mesh([devices[d * n_model:(d + 1) * n_model] for d in range(n_data)],
                (DATA_AXIS, MODEL_AXIS))


# ----------------------------------------------------------------------
# sharding rules: a spec names, for each dimension of a tensor, the mesh
# axis that splits it (None: whole), as JAX's PartitionSpec does


def _divisible(dim: int, shards: int) -> bool:
    return shards > 0 and dim % shards == 0


def param_pspec(shape, n_model: int) -> tuple:
    """Copied from the JAX package: the spec of one parameter of JAX-layout
    ``shape`` under tensor parallelism.  Shard the last (output / gate)
    dimension over the model axis where ``n_model`` divides it, else the
    first; leaves of one dimension, and those neither end of which divides,
    are replicated (``()``)."""
    if n_model <= 1 or len(shape) < 2:
        return replicated()
    if _divisible(shape[-1], n_model):
        return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
    if _divisible(shape[0], n_model):
        return (MODEL_AXIS,) + (None,) * (len(shape) - 1)
    return replicated()


def replicated() -> tuple:
    """The spec of a tensor every mesh position holds whole."""
    return ()


def batch_sharding(ndim: int) -> tuple:
    """The spec of a batch: rows (dim 0) over the data axis."""
    return (DATA_AXIS,) + (None,) * (ndim - 1)


def local_slice(t: torch.Tensor, spec: tuple, mesh: Mesh, index: dict) -> torch.Tensor:
    """The block of ``t`` that the mesh position ``index`` ({axis: index})
    holds under ``spec``: a view."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = t.shape[dim] // mesh.shape[axis]
            t = t.narrow(dim, index[axis] * n, n)
    return t


def param_shardings(state: dict, mesh: Mesh) -> dict:
    """{key: spec} for a ``LAS.state_dict()`` (or any dict of tensors under
    its keys), on the torch tensors' dimensions: ``param_pspec`` of the JAX
    leaf (``convert.asr_leaf_layout``), reversed where the torch tensor is
    that leaf transposed."""
    from ss_asr_tpu_torch import convert

    out = {}
    for k, t in state.items():
        shape, transposed = convert.asr_leaf_layout(k, tuple(t.shape))
        spec = param_pspec(shape, mesh.shape.get(MODEL_AXIS, 1))
        out[k] = spec[::-1] if transposed else spec
    return out


def shard_params(state: dict, mesh: Mesh, m: int) -> dict:
    """The slices of ``state`` (a ``LAS.state_dict()``) that model index ``m``
    holds: the JAX package's ``shard_params`` seen from one rank."""
    specs = param_shardings(state, mesh)
    return {k: local_slice(t, specs[k], mesh, {MODEL_AXIS: m}) for k, t in state.items()}


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
    B, n = int(_leaves(tree)[0].shape[0]), len(mesh.data_devices)
    if B % n:
        raise ValueError(f"shard_batch: {B} rows do not divide over the {n}-device data axis")

    def rows(x, i, d):
        x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        return local_slice(x, batch_sharding(x.dim()), mesh, {DATA_AXIS: i}).to(d)

    return [_tree_map(lambda x, i=i, d=d: rows(x, i, d), tree)
            for i, d in enumerate(mesh.data_devices)]


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


def all_reduce_int(value: int, op: str, device, group=None) -> int:
    """``value`` reduced over the ranks (of ``group``; default all) by
    ``op`` ("min" or "max")."""
    t = torch.tensor([int(value)], dtype=torch.int64, device=_scalar_device(device))
    dist.all_reduce(t, op={"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}[op], group=group)
    return int(t)


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def average_gradients(params: Iterable[torch.Tensor], extras: Sequence[torch.Tensor] = (),
                      group=None) -> List[torch.Tensor]:
    """ONE flat all-reduce that averages over the ranks (of ``group``;
    default all: tensor parallelism passes the data group) every
    parameter's ``.grad`` (a ``None`` gradient taken as zeros, so that
    every rank reduces the same list) and each of ``extras`` (the loss; the
    SAE's new batch-norm statistics).  The averaged gradients are written
    back to ``.grad``; returns the averaged extras."""
    params = list(params)
    parts = [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
             for p in params] + [e.detach().reshape(-1) for e in extras]
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
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


class TensorParallel:
    """A rank's place on a ``(data, model)`` mesh of ranks and its two
    process groups: the model group (the ranks of its data index, which
    hold the same rows and one slice each of every sharded leaf) and the
    data group (the ranks of its model index, over which gradients
    average).  Every rank creates every group, in one order:
    ``dist.new_group`` is collective.  ``bytes`` counts what this rank's
    gathers and gradient averages hand to their all-reduces."""

    def __init__(self, mesh: Mesh, rank: int):
        self.mesh = mesh
        self.n_data, self.n_model = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
        self.d, self.m = divmod(rank, self.n_model)
        D, M = self.n_data, self.n_model
        groups = [dist.new_group([d * M + m for m in range(M)]) for d in range(D)]
        self.model_group = groups[self.d]
        groups = [dist.new_group([d * M + m for d in range(D)]) for m in range(M)]
        self.data_group = groups[self.m]
        self.bytes = {"gather": 0, "reduce": 0}

    def local(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's block of ``t`` under ``spec`` (a view)."""
        return local_slice(t, spec, self.mesh, {DATA_AXIS: self.d, MODEL_AXIS: self.m})

    @torch.no_grad()
    def gather_(self, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor, tuple]]) -> None:
        """For every ``(shard, full, spec)``, ``full`` written whole from the
        model group's shards, in ONE flat all-reduce over the group: each
        rank adds its shard at its place in a zero buffer (a sum with zeros
        is exact, and the group's ranks all receive the same bits).  gloo
        takes CUDA tensors in an all-reduce and in no all-gather."""
        full0 = pairs[0][1]
        flat = torch.zeros(sum(f.numel() for _, f, _ in pairs), dtype=full0.dtype,
                           device=full0.device)
        views, o = [], 0
        for shard, full, spec in pairs:
            v = flat[o:o + full.numel()].view(full.shape)
            self.local(v, spec).copy_(shard)
            views.append(v)
            o += full.numel()
        dist.all_reduce(flat, group=self.model_group)
        self.bytes["gather"] += flat.numel() * flat.element_size()
        for (_, full, _), v in zip(pairs, views):
            full.copy_(v)
