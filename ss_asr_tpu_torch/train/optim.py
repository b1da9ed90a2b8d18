"""Optimizers with the reference's clip-and-skip semantics.

Port of ``ss_asr_tpu/train/optim.py`` ``make_optimizer`` at a constant
rate: ``optax.apply_if_finite(chain(clip_by_global_norm(grad_clip),
<adadelta | adam | sgd>(learning_rate, eps)))``, written out in PyTorch so
that each step equals optax's:

* **The NaN skip** (``apply_if_finite``): a step whose gradients hold a NaN
  or an infinity changes neither the parameters nor the accumulators; the
  three counters ``notfinite_count`` (consecutive skipped steps, reset by a
  finite one), ``last_finite`` and ``total_notfinite`` record it.  After
  ``MAX_CONSECUTIVE_ERRORS`` skips in a row the step is taken anyway.
* **The clip** (``clip_by_global_norm``): the gradients are scaled by
  ``max_norm / g_norm`` when ``g_norm >= max_norm``, with no ``+ 1e-6`` in
  the denominator (torch's ``clip_grad_norm_`` adds one).
* **Adadelta** with ``rho`` 0.9 and ``eps`` 1e-8 (optax's update, not torch's
  ``Adadelta``, whose default eps is 1e-6 and whose update differs in
  where eps enters): ``e_g = rho e_g + (1 - rho) g^2``, ``d = sqrt(e_x +
  eps) / sqrt(e_g + eps) * g``, ``e_x = rho e_x + (1 - rho) d^2``, ``p -=
  lr * d``.  Adam: optax's ``scale_by_adam`` (bias-corrected, ``eps``
  outside the root).  SGD: ``p -= lr * g``.

* **Masks** (``optax.masked`` over a boolean tree, for the trainers that
  update a subtree of several models' parameters): only the names in
  ``mask`` are trained and carry accumulators, and the clip's global norm
  runs over them alone; but the NaN skip reads EVERY parameter's gradient,
  the frozen ones' included, as ``apply_if_finite`` wraps the whole chain.
* **Update scales**: after the inner update, ``(names, factor)`` multiplies
  the update of those names (``sae.listener_lr_scale``).

* **Schedules** (``make_schedule``): a linear warm-up from 0 over
  ``warmup_steps`` updates, then the peak rate, or a cosine decay over
  ``decay_steps`` more updates (the horizon AFTER the warm-up) down to
  ``end_scale`` times the peak; optax's ``linear_schedule`` /
  ``warmup_cosine_decay_schedule``, in float32 and in optax's order of
  operations.  The rate of an update is the schedule at the count of the
  updates before it (optax's ``scale_by_schedule`` count, which only a
  schedule has).
* **Gradient accumulation** (``accum_steps`` k > 1; optax's ``MultiSteps``
  inside ``apply_if_finite``): each accepted call folds its gradients, every
  parameter's (the frozen ones' too), into a running mean, ``acc + (g -
  acc) / (n + 1)`` (Welford's, not a sum divided by k); the k-th accepted
  call runs the clip and the inner update (and steps the schedule) once on
  that mean and resets it.  A call with a non-finite gradient is skipped
  whole: it moves no mini-step and is absent from the mean.

* **Tensor parallelism** (``with_state``; ``parallel/mesh.py``): the
  optimizer over a model rank's shards, its slots cut the same way.  The
  clip's norm counts each element once (``global_norm``: the shards'
  squares summed over the model group, the replicated leaves' added once),
  and the NaN skip's ``finite`` is agreed over the group, so that every rank
  takes the same skip, accumulation and schedule decision; the updates are
  elementwise on the shards.

The parameters are updated in place.  The accumulators are kept per
parameter name; ``convert`` writes and reads them in the JAX package's npz
layout.  ``prefix_mask`` / ``path_mask`` select names by their dotted path,
as the JAX package's select leaves by key path.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

SLOTS = {"adadelta": ("e_g", "e_x"), "adam": ("mu", "nu"), "sgd": ()}

GRAD_CLIP = 5.0  # the reference's global-norm bound
EPS = 1e-8  # make_optimizer's eps (Adadelta, Adam)
RHO = 0.9  # optax's Adadelta decay
B1, B2 = 0.9, 0.999  # optax's Adam decays
MAX_CONSECUTIVE_ERRORS = 10**8  # skipped steps in a row before one is taken: "always skip"

_INT32_MAX = 2**31 - 1


def _safe_increment(n: torch.Tensor) -> torch.Tensor:
    """optax's ``safe_increment``: add one, saturating at the int32 maximum."""
    return torch.where(n < _INT32_MAX, n + 1, n)


def _inc(n: int) -> int:
    """``_safe_increment`` of a count kept on the host."""
    return n + 1 if n < _INT32_MAX else n


def make_schedule(learning_rate: float, warmup_steps: int = 0, decay_steps: int = 0,
                  end_scale: float = 0.0, dtype=np.float32
                  ) -> Union[float, Callable[[int], float]]:
    """The learning rate, or the schedule ``count -> rate`` (see the module
    docstring), as ``ss_asr_tpu/train/optim.py::make_schedule`` builds it:
    optax's ``linear_schedule`` (warm-up only) or
    ``warmup_cosine_decay_schedule(decay_steps=warmup + decay)``, each
    operation rounded to ``dtype`` as optax's float32 is (float64 gives the
    same formula unrounded)."""
    if not warmup_steps and not decay_steps:
        return learning_rate
    f = dtype
    W, D, lr = int(warmup_steps), int(decay_steps), float(learning_rate)
    init = 0.0 if W else lr

    def linear(count: int):  # polynomial_schedule(power=1) from init to lr over W
        if W <= 0:
            return f(init)
        frac = f(1) - f(f(min(max(count, 0), W)) / f(W))
        return f(f(init - lr) * frac) + f(lr)

    if not D:
        return lambda count: float(linear(count))
    alpha = 0.0 if lr == 0.0 else (end_scale * lr) / lr

    def cosine(count: int):  # cosine_decay_schedule(lr, D, alpha)
        c = f(min(count, D))
        decay = f(0.5) * (f(1) + f(np.cos(np.float64(f(f(math.pi) * c) / f(D)))))
        return f(lr) * (f(f(1.0 - alpha) * decay) + f(alpha))

    return lambda count: float(linear(count) if count < W else cosine(count - W))


def global_norm(grads: Dict[str, torch.Tensor], shards: Set[str] = frozenset(),
                group=None) -> torch.Tensor:
    """The clip's global norm, ``sqrt`` of the sum of every element's square
    (optax's ``global_norm``).  Under tensor parallelism ``shards`` names
    the gradients that are this rank's slices: their squares are summed over
    ``group`` (the model group) and the replicated gradients' added once."""
    if group is None:
        return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    import torch.distributed as dist

    part = sum(torch.sum(g * g) for k, g in grads.items() if k in shards)
    dist.all_reduce(part, group=group)
    return torch.sqrt(part + sum(torch.sum(g * g) for k, g in grads.items() if k not in shards))


def path_mask(names: Iterable[str], pred: Callable[[Tuple[str, ...]], bool]) -> Set[str]:
    """The names whose dotted path satisfies ``pred`` (a tuple of its parts)."""
    return {n for n in names if pred(tuple(n.split(".")))}


def prefix_mask(names: Iterable[str], prefixes: Sequence[Tuple[str, ...]]) -> Set[str]:
    """The names whose dotted path starts with any of the given prefixes."""
    return path_mask(names, lambda path: any(path[: len(p)] == tuple(p) for p in prefixes))


class Optimizer:
    """clip -> Adadelta / Adam / SGD under the NaN skip, over named
    parameters; ``mask`` (names) restricts the update to a subset,
    ``update_scales`` [(names, factor)] damps some of its updates,
    ``accum_steps`` averages that many accepted calls into one update, and
    ``warmup_steps`` / ``decay_steps`` / ``end_scale`` schedule its rate."""

    def __init__(self, params: Iterable[Tuple[str, torch.Tensor]], opt_type: str,
                 learning_rate: float, mask: Optional[Iterable[str]] = None,
                 update_scales: Optional[Sequence[Tuple[Iterable[str], float]]] = None,
                 accum_steps: int = 1, warmup_steps: int = 0, decay_steps: int = 0,
                 end_scale: float = 0.0):
        self.opt_type = opt_type.lower()
        if self.opt_type not in SLOTS:
            raise ValueError(f"Unknown optimizer type: {opt_type}")
        self.params: Dict[str, torch.Tensor] = dict(params)
        self.mask = set(self.params) if mask is None else set(mask)
        if not self.mask <= set(self.params):
            raise ValueError(f"mask names {sorted(self.mask - set(self.params))} are no parameters")
        self.scales = [(set(names), float(f)) for names, f in update_scales or ()]
        self.schedule = make_schedule(float(learning_rate), warmup_steps, decay_steps, end_scale)
        self.scheduled = callable(self.schedule)
        self.accum_steps = max(int(accum_steps or 1), 1)
        dev = next(iter(self.params.values())).device
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.last_finite = torch.ones((), dtype=torch.bool, device=dev)
        self.total_notfinite = torch.zeros((), dtype=torch.int32, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)  # Adam's step count
        # host counts: the schedule's updates, MultiSteps' mini_step and gradient_step
        self.sched_count = self.mini_step = self.gradient_step = 0
        self.slots = SLOTS[self.opt_type]
        self.state: Dict[str, Dict[str, torch.Tensor]] = {
            s: {k: torch.zeros_like(p) for k, p in self.params.items() if k in self.mask}
            for s in self.slots}
        # the running mean of the accepted calls' gradients, every parameter's
        self.acc_grads: Dict[str, torch.Tensor] = (
            {k: torch.zeros_like(p) for k, p in self.params.items()}
            if self.accum_steps > 1 else {})
        # tensor parallelism: the names of this rank's shards, and the model group
        self.shards: Set[str] = set()
        self.group = None

    def with_state(self, fn: Callable[[str, torch.Tensor], torch.Tensor],
                   params: Optional[Dict[str, torch.Tensor]] = None, group=None) -> "Optimizer":
        """A shallow copy whose slots and running means are ``fn(name,
        tensor)`` of this one's.  Tensor parallelism cuts the optimizer into
        a rank's shards with it (``params``: the parameters under the same
        names, a rank's slice where one is not the parameter itself;
        ``group``: the model group), and gathers the slots back for a
        checkpoint.  The counters are shared until the next step replaces
        them."""
        o = copy.copy(self)
        o.state = {s: {k: fn(k, v) for k, v in d.items()} for s, d in self.state.items()}
        o.acc_grads = {k: fn(k, v) for k, v in self.acc_grads.items()}
        if params is not None:
            o.shards = {k for k, p in params.items() if p is not self.params[k]}
            o.params, o.group = dict(params), group
        return o

    def rate(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.sched_count) if self.scheduled else self.schedule

    @torch.no_grad()
    def step(self) -> bool:
        """One call with the parameters' ``.grad`` (None counts as zero):
        an update, or with ``accum_steps`` k one of k accumulated calls.
        Returns whether the call was accepted (its gradients finite)."""
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in self.params.items()}
        finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
        if self.group is not None:  # every model rank takes the same decision
            from ss_asr_tpu_torch.parallel.mesh import all_reduce_int

            finite = torch.full_like(finite, bool(all_reduce_int(int(finite), "min",
                                                                 finite.device, self.group)))
        self.notfinite_count = torch.where(finite, torch.zeros_like(self.notfinite_count),
                                           _safe_increment(self.notfinite_count))
        self.total_notfinite = torch.where(finite, self.total_notfinite,
                                           _safe_increment(self.total_notfinite))
        self.last_finite = finite
        take = bool(finite) or int(self.notfinite_count) > MAX_CONSECUTIVE_ERRORS
        if not take:
            return False
        if self.accum_steps == 1:  # the frozen parameters' gradients go no further than the check
            self._update({k: g for k, g in grads.items() if k in self.mask})
            return True
        # MultiSteps' mean; a divisor on the device divides exactly (a host scalar's
        # reciprocal would be multiplied on the card)
        some = next(iter(self.acc_grads.values()))
        n = torch.full((), self.mini_step + 1, dtype=some.dtype, device=some.device)
        for k, g in grads.items():
            acc = self.acc_grads[k]
            acc.add_((g - acc) / n)
        if self.mini_step == self.accum_steps - 1:
            self._update({k: g for k, g in self.acc_grads.items() if k in self.mask})
            for acc in self.acc_grads.values():
                acc.zero_()
            self.gradient_step = _inc(self.gradient_step)
        self.mini_step = _inc(self.mini_step) % self.accum_steps
        return True

    def _update(self, grads: Dict[str, torch.Tensor]) -> None:
        g_norm = global_norm(grads, self.shards, self.group)
        if not bool(g_norm < GRAD_CLIP):
            grads = {k: (g / g_norm) * GRAD_CLIP for k, g in grads.items()}
        if self.opt_type == "adam":
            self.count = _safe_increment(self.count)
            c1 = 1 - torch.tensor(B1, dtype=torch.float32) ** self.count.float()
            c2 = 1 - torch.tensor(B2, dtype=torch.float32) ** self.count.float()
        lr = self.rate()
        if self.scheduled:
            self.sched_count = _inc(self.sched_count)
        for k, g in grads.items():
            if self.opt_type == "adadelta":
                e_g, e_x = self.state["e_g"][k], self.state["e_x"][k]
                e_g.copy_((1 - RHO) * (g * g) + RHO * e_g)
                d = torch.sqrt(e_x + EPS) / torch.sqrt(e_g + EPS) * g
                e_x.copy_((1 - RHO) * (d * d) + RHO * e_x)
            elif self.opt_type == "adam":
                mu, nu = self.state["mu"][k], self.state["nu"][k]
                mu.copy_((1 - B1) * g + B1 * mu)
                nu.copy_((1 - B2) * (g * g) + B2 * nu)
                d = (mu / c1.to(mu.device)) / (torch.sqrt(nu / c2.to(nu.device)) + EPS)
            else:
                d = g
            u = d * -lr
            for names, factor in self.scales:
                if k in names:
                    u = u * factor
            self.params[k].add_(u)
