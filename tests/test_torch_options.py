"""The trainers' options in the port against the JAX package's, on the CPU.

* ``make_schedule`` against optax's float32 schedule (``ss_asr_tpu/train/
  optim.py::make_schedule``) at every count up to warm-up + decay + 3: warm-up
  only, warm-up + cosine, cosine only, a cosine floor (``end_scale``).
* ``Optimizer`` against ``make_optimizer`` for Adadelta, Adam and SGD, with
  and without a mask, an update scale and a schedule, at ``accum_steps`` 1,
  2 and 3, over 2k + 1 calls of which one holds a NaN and one has a norm
  above the clip: every parameter and every state leaf (``convert``'s
  layout, in ``jax.tree.leaves`` order) after every call, within 1e-6.
* Optimizer-state files written by either package load into the other in
  the middle of an accumulation, and the next call agrees.
* k micro-batches of B accumulated equal one batch of k * B, in float64.
* The trainers with these options: ``test_torch_options_trainers.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss_asr_tpu.train.optim import make_optimizer
from ss_asr_tpu.train.optim import make_schedule as jmake_schedule
from ss_asr_tpu.train.optim import prefix_mask as jprefix_mask
from ss_asr_tpu.utils import checkpoint as jckpt
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.models import text_autoencoder as tae_mod
from ss_asr_tpu_torch.train import losses
from ss_asr_tpu_torch.train.optim import Optimizer, make_schedule, prefix_mask
from ss_asr_tpu_torch.train.solver import joint_named_parameters
from ss_asr_tpu_torch.utils import checkpoint as ckpt
from test_torch_adv import disc_module
from test_torch_tae import TAE_MDL, assert_trees_close, load_modules

torch.set_num_threads(1)

OPT_ATOL = 1e-6  # the optax parity tests' tolerance
LRS = {"adadelta": 1.0, "adam": 1e-3, "sgd": 0.1}
SCHEDULE = {"warmup_steps": 1, "decay_steps": 3, "end_scale": 0.1}


# --------------------------------------------------------------------------
# the schedule


@pytest.mark.parametrize("lr,warmup,decay,end", [(1.0, 5, 0, 0.0), (0.37, 11, 37, 0.0),
                                                 (0.7, 0, 9, 0.0), (3e-4, 3, 5, 0.1)],
                         ids=["warmup", "warmup_cosine", "cosine", "end_scale"])
def test_schedule_matches_optax(lr, warmup, decay, end):
    want, got = jmake_schedule(lr, warmup, decay, end), make_schedule(lr, warmup, decay, end)
    for count in range(warmup + decay + 4):
        w, g = np.float32(want(jnp.int32(count))), np.float32(got(count))
        ulps = abs(int(w.view(np.int32)) - int(g.view(np.int32)))
        assert ulps <= 1, (count, w, g)
    f64 = make_schedule(lr, warmup, decay, end, dtype=np.float64)
    for count in range(warmup + decay + 4):
        assert abs(f64(count) - got(count)) <= 1e-6 * lr


def test_constant_rate_is_no_schedule():
    assert make_schedule(0.5) == 0.5
    opt = Optimizer([("w", torch.nn.Parameter(torch.zeros(2)))], "SGD", 0.5)
    assert not opt.scheduled and opt.rate() == 0.5 and opt.accum_steps == 1


# --------------------------------------------------------------------------
# the optimizer


def _trees(rng):
    return {"disc": convert.init_disc_numpy(1, _disc_cfg()),
            "tae": convert.init_tae_numpy(2, tae_mod.TAEConfig(**TAE_MDL))}


def _disc_cfg():
    from ss_asr_tpu_torch.models import discriminator as disc_mod

    return disc_mod.DiscriminatorConfig(in_dim=16, hidden_dim=12)


def _port_models(trees):
    (tae,) = load_modules(tae_tree=trees["tae"])
    return {"disc": disc_module(trees["disc"]), "tae": tae}


def _grad_trees(rng, trees, n):
    """n gradient trees: small, one with a NaN (in a leaf the mask freezes),
    one of norm > 5 (the clip), the rest small."""
    seq = []
    for i in range(n):
        g = jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32), trees)
        if i == 1:
            g["tae"]["encoder"]["emb"]["table"][0, 1] = np.nan
        if i == 2:
            g = jax.tree.map(lambda a: 40.0 * a, g)
        seq.append(g)
    return seq


def _set_grads(models, g):
    for key, m in models.items():
        sd = convert.STATE_FROM_PARAMS[key](g[key])
        for n, p in m.named_parameters():
            p.grad = sd[n].clone() if p.requires_grad else None


def _pair(trees, opt_type, masked, scaled, sched, k):
    """(the optax chain's update, jitted as the JAX trainers call it, its
    state, the JAX params, the port's models and Optimizer, the mask's
    prefixes) over one joint {disc, tae} tree."""
    prefixes = (("disc",),) if masked else None
    kw = dict(accum_steps=k, **(SCHEDULE if sched else {}))
    jparams = jax.tree.map(jnp.asarray, trees)
    tx = make_optimizer(opt_type, LRS[opt_type],
                        mask=jprefix_mask(jparams, prefixes) if masked else None,
                        update_scales=[(jprefix_mask(jparams, (("disc", "fc1"),)), 0.5)]
                        if scaled else None, **kw)
    models = _port_models(trees)
    named = joint_named_parameters(models)
    names = [n for n, _ in named]
    opt = Optimizer(named, opt_type, LRS[opt_type],
                    mask=prefix_mask(names, prefixes) if masked else None,
                    update_scales=[(prefix_mask(names, (("disc", "core", "0"),)), 0.5)]
                    if scaled else None, **kw)
    return jax.jit(tx.update), tx.init(jparams), jparams, models, opt, prefixes


def _jax_call(update, state, jparams, g):
    upd, state = update(jax.tree.map(jnp.asarray, g), state, jparams)
    return jax.tree.map(lambda p, u: p + u, jparams, upd), state


def _port_tree(models):
    return {key: convert.PARAMS_FROM_STATE[key](m.state_dict()) for key, m in models.items()}


def _assert_state(opt, models, prefixes, state, atol=OPT_ATOL):
    got = convert.opt_state_leaves(opt, models, prefixes)
    want = [np.asarray(w) for w in jax.tree.leaves(state)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"leaf {i}")


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("sched", [False, True], ids=["const", "sched"])
@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "scaled"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("opt_type", ["adadelta", "adam", "sgd"])
def test_optimizer_matches_optax(rng, opt_type, masked, scaled, sched, k):
    trees = _trees(rng)
    update, state, jparams, models, opt, prefixes = _pair(trees, opt_type, masked, scaled, sched,
                                                           k)
    taken = []
    for g in _grad_trees(rng, trees, 2 * k + 1):
        jparams, state = _jax_call(update, state, jparams, g)
        _set_grads(models, g)
        taken.append(opt.step())
        assert_trees_close(_port_tree(models), jax.tree.map(np.asarray, jparams), OPT_ATOL)
        _assert_state(opt, models, prefixes, state)
    assert taken == [True, False] + [True] * (2 * k - 1)
    assert opt.gradient_step == (2 if k > 1 else 0) and opt.mini_step == 0
    assert opt.sched_count == (2 if sched else 0)
    if masked:  # the frozen subtree never moves
        for g, w in zip(convert.tree_leaves(_port_tree(models)["tae"]),
                        convert.tree_leaves(trees["tae"])):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("opt_type", ["adadelta", "adam", "sgd"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_files_cross_load_mid_accumulation(rng, tmp_path, opt_type, writer):
    """Three accepted calls at k = 2 (mini_step 1, a non-zero running mean),
    written by one package and read by the other; then a fourth call in both."""
    trees = _trees(rng)
    seq = [g for i, g in enumerate(_grad_trees(rng, trees, 5)) if i != 1]
    update, state, jparams, models, opt, prefixes = _pair(trees, opt_type, True, False, True, 2)
    fresh_state = state
    for g in seq[:3]:
        jparams, state = _jax_call(update, state, jparams, g)
        _set_grads(models, g)
        opt.step()
    path = str(tmp_path / "opt.npz")
    models_r = _port_models(jax.tree.map(np.array, jparams))
    named = joint_named_parameters(models_r)
    fresh = Optimizer(named, opt_type, LRS[opt_type],
                      mask=prefix_mask([n for n, _ in named], prefixes), accum_steps=2,
                      **SCHEDULE)
    if writer == "jax":
        jckpt.save_opt_state(path, state)
        leaves = ckpt.load_opt_state(path)
        assert convert.load_opt_state_leaves(fresh, models_r, prefixes, leaves)
        got = convert.opt_state_leaves(fresh, models_r, prefixes)
        for g, w in zip(got, leaves):
            np.testing.assert_array_equal(g, w)
        assert fresh.mini_step == 1 and fresh.gradient_step == 1 and fresh.sched_count == 1
        assert max(float(np.abs(a.numpy()).max()) for a in fresh.acc_grads.values()) > 0
        opt, models = fresh, models_r
    else:
        ckpt.save_opt_state(path, convert.opt_state_leaves(opt, models, prefixes))
        state = jckpt.load_opt_state(path, fresh_state)
        for g, w in zip(jax.tree.leaves(state), ckpt.load_opt_state(path)):
            np.testing.assert_array_equal(np.asarray(g), w)
    jparams, state = _jax_call(update, state, jparams, seq[3])
    _set_grads(models, seq[3])
    opt.step()
    assert opt.mini_step == 0 and opt.gradient_step == 2
    assert_trees_close(_port_tree(models), jax.tree.map(np.asarray, jparams), OPT_ATOL)
    _assert_state(opt, models, prefixes, state)


def test_a_file_of_another_layout_leaves_the_optimizer_fresh(rng):
    trees = _trees(rng)
    models = _port_models(trees)
    named = joint_named_parameters(models)
    plain = Optimizer(named, "adadelta", 1.0)
    accum = Optimizer(named, "adadelta", 1.0, accum_steps=2)
    sched = Optimizer(named, "adadelta", 1.0, warmup_steps=2)
    for src, dst in ((plain, accum), (accum, plain), (plain, sched), (sched, accum)):
        assert not convert.load_opt_state_leaves(dst, models, None,
                                                 convert.opt_state_leaves(src, models))
    assert accum.mini_step == 0 and sched.sched_count == 0


@pytest.mark.parametrize("k", [2, 3])
def test_k_micro_batches_equal_one_batch_of_k_b_in_float64(rng, k):
    """The running mean of k micro-batches' gradients, then one update,
    against the gradient of the whole batch, then one update (teacher
    forcing: no draw matters)."""
    mdl = {"encoder_state_size": 8, "mlp_out_size": 8, "decoder_state_size": 8,
           "tf_rate": 1.0, "feature_dim": 8}
    cfg = las.ASRConfig(**mdl)
    tree = convert.init_asr_numpy(5, cfg)
    B, T, L = 2 * k, 24, 6
    x = torch.from_numpy(rng.standard_normal((B, T, 8))).double()
    x_lens = torch.from_numpy(rng.integers(9, T + 1, size=B))
    y = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(B, L + 1)))
    y[:, 0] = 0
    runs = []
    for micro in (k, 1):
        model = las.LAS(cfg)
        model.load_state_dict(convert.asr_state_from_params(tree))
        model.double()
        for n, p in model.named_parameters():
            p.requires_grad_("bias_hh" not in n)
        opt = Optimizer([(n, p) for n, p in model.named_parameters() if p.requires_grad],
                        "Adadelta", 1.0, accum_steps=micro, **SCHEDULE)
        for part in range(micro):
            sl = slice(part * B // micro, (part + 1) * B // micro)
            model.zero_grad(set_to_none=True)
            draws = las.draw_scheduled_sampling(L, B // micro, 1.0, cfg, device="cpu")
            logits = las.asr_forward(model, x[sl], x_lens[sl], L, teacher=y[sl],
                                     tf_draws=draws[0], gumbel=draws[1].double())[1]
            losses.masked_ce_per_utt(logits, y[sl, 1:], y[sl]).backward()
            assert opt.step()
        assert opt.sched_count == 1 and opt.mini_step == 0
        runs.append((dict(model.named_parameters()), opt))
    (p_k, o_k), (p_1, o_1) = runs
    for n in p_1:
        np.testing.assert_allclose(p_k[n].detach().numpy(), p_1[n].detach().numpy(), rtol=0,
                                   atol=1e-12, err_msg=n)
    for n in o_1.state["e_g"]:
        for s in ("e_g", "e_x"):
            np.testing.assert_allclose(o_k.state[s][n].numpy(), o_1.state[s][n].numpy(),
                                       rtol=1e-9, atol=1e-18, err_msg=f"{s} {n}")
