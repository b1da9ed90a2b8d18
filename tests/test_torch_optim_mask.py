"""The port's masked optimizers against the JAX package's ``make_optimizer``.

The parameters are a joint tree of two models, {"asr": {"encoder",
"decoder"}, "tae": ...}; the mask trains ``tae`` and ``asr/decoder``.  Over a
sequence of gradients (a norm above the clip; a NaN in a FROZEN leaf, which
must skip the step; a NaN in a trained leaf) the port's ``Optimizer`` follows
optax leaf by leaf: parameters and accumulators within 1e-6 (float32
arithmetic in another order), counters equal, frozen leaves bit-unchanged.
The optimizer state goes both ways through the npz layout of
``utils.checkpoint.save_opt_state``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss_asr_tpu.train.optim import make_optimizer, prefix_mask as jprefix_mask
from ss_asr_tpu.utils import checkpoint as jckpt
from ss_asr_tpu_torch.train.optim import Optimizer, path_mask, prefix_mask
from ss_asr_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

SHAPES = {"asr.encoder.w": (3, 4), "asr.decoder.w": (2, 5), "asr.decoder.b": (5,),
          "tae.w": (7,)}
TRAINED = (("tae",), ("asr", "decoder"))
ATOL = 1e-6


def _tree(flat):
    """{"a.b.c": v} -> nested dict, the JAX package's tree."""
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _grads(rng, n=3, nan_at=None, big_at=None):
    seq = []
    for i in range(n):
        g = {k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
        if nan_at and i in nan_at:
            g[nan_at[i]].flat[0] = np.nan
        if i == big_at:
            g = {k: 40.0 * v for k, v in g.items()}
        seq.append(g)
    return seq


def _run(rng, opt_type, lr, seq, scales=None):
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    jp = jax.tree.map(jnp.asarray, _tree(params))
    jscales = [(jprefix_mask(jp, pre), f) for pre, f in scales or ()] or None
    tx = make_optimizer(opt_type, lr, mask=jprefix_mask(jp, TRAINED), update_scales=jscales)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    tscales = [(prefix_mask(tp, pre), f) for pre, f in scales or ()] or None
    opt = Optimizer(tp.items(), opt_type, lr, mask=prefix_mask(tp, TRAINED),
                    update_scales=tscales)
    taken = []
    for g in seq:
        upd, state = tx.update(jax.tree.map(jnp.asarray, _tree(g)), state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        taken.append(opt.step())
        want = {".".join(str(x.key) for x in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].detach().numpy(), want[k], rtol=0, atol=ATOL,
                                       err_msg=k)
        np.testing.assert_array_equal(tp["asr.encoder.w"].detach().numpy(),
                                      params["asr.encoder.w"])
    return opt, state, tp, taken


def _port_leaves(opt):
    """The port's state in optax's leaf order: counters, Adam's count, then
    each accumulator over the trained names in sorted tree order."""
    leaves = [opt.notfinite_count, opt.last_finite, opt.total_notfinite]
    leaves += [opt.count] if opt.opt_type == "adam" else []
    order = sorted(opt.mask, key=lambda n: n.split("."))
    return [t.numpy() for t in leaves] + [opt.state[s][k].numpy() for s in opt.slots
                                          for k in order]


@pytest.mark.parametrize("opt_type,lr", [("Adadelta", 1.0), ("Adam", 1e-3), ("SGD", 0.1)])
def test_masked_optimizer_matches_optax_over_three_steps(rng, opt_type, lr):
    opt, state, _, taken = _run(rng, opt_type, lr, _grads(rng, big_at=1))
    assert taken == [True, True, True]
    want = [np.asarray(x) for x in jax.tree.leaves(state)]
    got = _port_leaves(opt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    assert set(opt.state[opt.slots[0]]) == opt.mask if opt.slots else True


@pytest.mark.parametrize("leaf", ["asr.encoder.w", "tae.w"], ids=["frozen", "trained"])
def test_nan_skip_reads_every_gradient(rng, leaf):
    """apply_if_finite wraps the whole chain: a NaN in a frozen leaf's
    gradient skips the step too."""
    opt, state, _, taken = _run(rng, "Adadelta", 1.0, _grads(rng, nan_at={1: leaf}))
    assert taken == [True, False, True]
    assert int(opt.total_notfinite) == int(state.total_notfinite) == 1
    assert int(opt.notfinite_count) == int(state.notfinite_count) == 0


def test_update_scales_damp_after_the_inner_update(rng):
    opt, state, tp, _ = _run(rng, "Adadelta", 1.0, _grads(rng),
                             scales=[((("asr", "decoder"),), 0.25)])
    want = [np.asarray(x) for x in jax.tree.leaves(state)]
    for g, w in zip(_port_leaves(opt), want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_clip_norm_runs_over_the_trained_subtree_only(rng):
    """A huge gradient on the frozen leaf must not shrink the trained update."""
    seq = _grads(rng, n=1)
    seq[0]["asr.encoder.w"] = seq[0]["asr.encoder.w"] * 1e6
    _run(rng, "SGD", 0.1, seq)  # parity with optax inside


def test_opt_state_npz_round_trip_both_ways(rng, tmp_path):
    opt, state, tp, _ = _run(rng, "Adam", 1e-3, _grads(rng))
    # JAX writes, the port's leaf order reads
    jckpt.save_opt_state(str(tmp_path / "j.npz"), state)
    for g, w in zip(_port_leaves(opt), ckpt.load_opt_state(str(tmp_path / "j.npz"))):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    # the port writes, JAX loads into a fresh state of the same chain
    ckpt.save_opt_state(str(tmp_path / "p.npz"), _port_leaves(opt))
    jp = jax.tree.map(jnp.asarray, _tree({k: v.detach().numpy() for k, v in tp.items()}))
    fresh = make_optimizer("Adam", 1e-3, mask=jprefix_mask(jp, TRAINED)).init(jp)
    loaded = jckpt.load_opt_state(str(tmp_path / "p.npz"), fresh)
    assert jax.tree.structure(loaded) == jax.tree.structure(state)
    for g, w in zip(jax.tree.leaves(loaded), jax.tree.leaves(state)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=ATOL)


def test_masks_select_names_by_path():
    names = list(SHAPES)
    assert prefix_mask(names, TRAINED) == {"asr.decoder.w", "asr.decoder.b", "tae.w"}
    assert path_mask(names, lambda p: p[-1] == "b") == {"asr.decoder.b"}
    with pytest.raises(ValueError, match="are no parameters"):
        Optimizer([("a", torch.nn.Parameter(torch.zeros(2)))], "SGD", 0.1, mask={"b"})
