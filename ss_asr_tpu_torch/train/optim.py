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

The parameters are updated in place.  The accumulators are kept per
parameter name; ``convert`` writes and reads them in the JAX package's npz
layout.  ``prefix_mask`` / ``path_mask`` select names by their dotted path,
as the JAX package's select leaves by key path.  Schedules and gradient
accumulation are ROADMAP item 8.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Set, Tuple

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


def path_mask(names: Iterable[str], pred: Callable[[Tuple[str, ...]], bool]) -> Set[str]:
    """The names whose dotted path satisfies ``pred`` (a tuple of its parts)."""
    return {n for n in names if pred(tuple(n.split(".")))}


def prefix_mask(names: Iterable[str], prefixes: Sequence[Tuple[str, ...]]) -> Set[str]:
    """The names whose dotted path starts with any of the given prefixes."""
    return path_mask(names, lambda path: any(path[: len(p)] == tuple(p) for p in prefixes))


class Optimizer:
    """clip -> Adadelta / Adam / SGD under the NaN skip, over named
    parameters; ``mask`` (names) restricts the update to a subset,
    ``update_scales`` [(names, factor)] damps some of its updates."""

    def __init__(self, params: Iterable[Tuple[str, torch.Tensor]], opt_type: str,
                 learning_rate: float, mask: Optional[Iterable[str]] = None,
                 update_scales: Optional[Sequence[Tuple[Iterable[str], float]]] = None):
        self.opt_type = opt_type.lower()
        if self.opt_type not in SLOTS:
            raise ValueError(f"Unknown optimizer type: {opt_type}")
        self.params: Dict[str, torch.Tensor] = dict(params)
        self.mask = set(self.params) if mask is None else set(mask)
        if not self.mask <= set(self.params):
            raise ValueError(f"mask names {sorted(self.mask - set(self.params))} are no parameters")
        self.scales = [(set(names), float(f)) for names, f in update_scales or ()]
        self.lr = float(learning_rate)
        dev = next(iter(self.params.values())).device
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.last_finite = torch.ones((), dtype=torch.bool, device=dev)
        self.total_notfinite = torch.zeros((), dtype=torch.int32, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)  # Adam's step count
        self.slots = SLOTS[self.opt_type]
        self.state: Dict[str, Dict[str, torch.Tensor]] = {
            s: {k: torch.zeros_like(p) for k, p in self.params.items() if k in self.mask}
            for s in self.slots}

    @torch.no_grad()
    def step(self) -> bool:
        """One update from the parameters' ``.grad`` (None counts as zero).
        Returns whether the step was taken."""
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in self.params.items()}
        finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
        self.notfinite_count = torch.where(finite, torch.zeros_like(self.notfinite_count),
                                           _safe_increment(self.notfinite_count))
        self.total_notfinite = torch.where(finite, self.total_notfinite,
                                           _safe_increment(self.total_notfinite))
        self.last_finite = finite
        take = bool(finite) or int(self.notfinite_count) > MAX_CONSECUTIVE_ERRORS
        if take:  # the frozen parameters' gradients go no further than the check
            self._update({k: g for k, g in grads.items() if k in self.mask})
        return take

    def _update(self, grads: Dict[str, torch.Tensor]) -> None:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if not bool(g_norm < GRAD_CLIP):
            grads = {k: (g / g_norm) * GRAD_CLIP for k, g in grads.items()}
        if self.opt_type == "adam":
            self.count = _safe_increment(self.count)
            c1 = 1 - torch.tensor(B1, dtype=torch.float32) ** self.count.float()
            c2 = 1 - torch.tensor(B2, dtype=torch.float32) ** self.count.float()
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
            u = d * -self.lr
            for names, factor in self.scales:
                if k in names:
                    u = u * factor
            self.params[k].add_(u)
