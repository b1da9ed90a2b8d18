"""The port's discriminator and adversarial trainer against the JAX package's.

* ``discriminate`` on the same numpy-seeded tree: within 1e-6.
* The D-step's losses (label smoothing 0.1, the listener's output detached)
  and the G-step's loss with EVERY gradient of the joint {asr, tae, disc}
  tree against ``jax.value_and_grad``: within 2e-5.  In the D-step the
  listener's gradient is zero and the frozen text encoder's is not (the NaN
  check reads it); in the G-step the speller's and the TAE's are zero.
* Three D + G steps of the two ``ADVTrainer``s from the same npz files:
  every logged loss (rtol 1e-5), every parameter (1e-5), the speller and the
  TAE bit-unchanged, both optimizers' states leaf by leaf, and each package
  resumes from the other's ``adv.npz`` / ``adv_G_opt.npz`` / ``adv_D_opt.npz``.
  ``eval_index`` and ``valid_index`` both name the validation set.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import write_asr_corpus
from ss_asr_tpu.models import discriminator as jdisc
from ss_asr_tpu.models import las as jlas
from ss_asr_tpu.models import text_autoencoder as jtae
from ss_asr_tpu.train import losses as jlosses
from ss_asr_tpu.train import make_paras as jmake_paras
from ss_asr_tpu.train.adv_trainer import ADVTrainer as JADVTrainer
from ss_asr_tpu.utils import checkpoint as jckpt
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.models import discriminator as disc_mod
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.models import text_autoencoder as tae_mod
from ss_asr_tpu_torch.train.adv_trainer import D_TRAINED, G_TRAINED, ADVTrainer
from ss_asr_tpu_torch.train.solver import make_paras
from ss_asr_tpu_torch.utils import checkpoint as ckpt
from test_torch_tae import (ASR_MDL, TAE_MDL, TEXTS, assert_trees_close, grad_tree, jnp_tree,
                            load_modules, losses_of, paras, run, start)

torch.set_num_threads(1)

DISC_MDL = {"hidden_dim": 12}
ATOL = 1e-5
GRAD_ATOL = 2e-5
SMOOTH = 0.1


def disc_module(tree):
    m = disc_mod.Discriminator(disc_mod.DiscriminatorConfig(in_dim=16, **DISC_MDL))
    m.load_state_dict(convert.disc_state_from_params(tree))
    return m


@pytest.fixture(scope="module")
def trees():
    return {"asr": convert.init_asr_numpy(3, las.ASRConfig(**ASR_MDL)),
            "tae": convert.init_tae_numpy(4, tae_mod.TAEConfig(**TAE_MDL)),
            "disc": convert.init_disc_numpy(5, disc_mod.DiscriminatorConfig(in_dim=16, **DISC_MDL))}


@pytest.fixture
def batch(rng):
    x = rng.standard_normal((3, 32, 8)).astype(np.float32)
    x_lens = np.array([32, 20, 9], np.int32)
    y = np.zeros((3, 8), np.int32)
    for i, n in enumerate((6, 3, 1)):
        y[i, 1 : n + 1] = rng.integers(3, 50, size=n)
        y[i, n + 1] = 1
    return x, x_lens, y, ((y != 0).sum(-1) + 1).astype(np.int32)


def test_discriminate_matches_jax(rng, trees):
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    want = jdisc.discriminate(jnp_tree(trees["disc"]), jnp.asarray(x))
    got = disc_mod.discriminate(disc_module(trees["disc"]), torch.from_numpy(x))
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    back = convert.disc_params_from_state(disc_module(trees["disc"]).state_dict())
    for a, b in zip(convert.tree_leaves(back), convert.tree_leaves(trees["disc"])):
        np.testing.assert_array_equal(a, b)


class _Steps:
    """The port trainer's losses over given modules, without a Solver."""

    d_losses, g_loss = ADVTrainer.d_losses, ADVTrainer.g_loss

    def __init__(self, trees):
        asr, tae = load_modules(trees["asr"], trees["tae"])
        self.models = {"asr": asr, "tae": tae, "disc": disc_module(trees["disc"])}

    def grads(self):
        return {k: grad_tree(k, m) for k, m in self.models.items()}


def test_d_step_losses_and_every_gradient_match_jax(trees, batch):
    x, x_lens, y, y_lens = batch
    tae_cfg = jtae.TAEConfig(**TAE_MDL)

    def loss_fn(p):  # ADVTrainer.set_model's d_losses, which is local to it
        real = jtae.text_encode(p["tae"]["encoder"], tae_cfg, jnp.asarray(y), jnp.asarray(y_lens))
        d_real = jdisc.discriminate(p["disc"], real)
        rl = jlosses.bce(d_real, jnp.full_like(d_real, 1.0 - SMOOTH))
        fake = jax.lax.stop_gradient(jlas.listener_apply(
            p["asr"]["encoder"], jnp.asarray(x), jnp.asarray(x_lens))[0])
        d_fake = jdisc.discriminate(p["disc"], fake)
        fl = jlosses.bce(d_fake, jnp.zeros_like(d_fake))
        return rl + fl, (rl, fl)

    (_, (rl_w, fl_w)), g = jax.value_and_grad(loss_fn, has_aux=True)(jnp_tree(trees))
    s = _Steps(trees)
    rl, fl, real, fake = s.d_losses(torch.from_numpy(x), torch.from_numpy(x_lens),
                                    torch.from_numpy(y).long(), torch.from_numpy(y_lens), SMOOTH)
    (rl + fl).backward()
    assert real.shape == (3, 8, 16) and fake.shape == (3, 4, 16) and not fake.requires_grad
    np.testing.assert_allclose([float(rl.detach()), float(fl.detach())],
                               [float(rl_w), float(fl_w)], rtol=1e-5)
    for key, got in s.grads().items():
        assert_trees_close(got, g[key], GRAD_ATOL, key)
    assert all(p.grad is None for p in s.models["asr"].parameters())
    assert float(np.abs(np.asarray(g["tae"]["encoder"]["emb"]["table"])).max()) > 0


def test_g_step_loss_and_every_gradient_match_jax(trees, batch):
    x, x_lens, _, _ = batch

    def loss_fn(p):
        fake, _ = jlas.listener_apply(p["asr"]["encoder"], jnp.asarray(x), jnp.asarray(x_lens))
        d_out = jdisc.discriminate(p["disc"], fake)
        return jlosses.bce(d_out, jnp.ones_like(d_out))

    want, g = jax.value_and_grad(loss_fn)(jnp_tree(trees))
    s = _Steps(trees)
    loss = s.g_loss(torch.from_numpy(x), torch.from_numpy(x_lens))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for key, got in s.grads().items():
        assert_trees_close(got, g[key], GRAD_ATOL, key)
    assert all(p.grad is None for p in s.models["tae"].parameters())
    assert float(np.abs(grad_tree("asr", s.models["asr"])["encoder"]["pblstm1"]["fwd"]["w_ih"])
                 .max()) > 0


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("adv_corpus")
    idx = write_asr_corpus(tmp, TEXTS, feature_dim=8)
    opt = {"type": "Adadelta", "learning_rate": 1.0}
    return {"asr": {"mdl": dict(ASR_MDL)}, "tae": {"mdl": dict(TAE_MDL)},
            "adv": {"G_opt": dict(opt), "D_opt": {"type": "Adam", "learning_rate": 1e-3},
                    "mdl": dict(DISC_MDL), "train_index": idx, "valid_index": idx,
                    "t_bucket": 8, "l_bucket": 8, "train_batch_size": 4, "valid_batch_size": 5,
                    "n_epochs": 1, "valid_step": 2, "logging_step": 1, "save_step": 1000}}


def _adv_start(tmp_path, name, trees):
    start(tmp_path, name, asr=trees["asr"], tae=trees["tae"], adv=trees["disc"])


def _opt_leaves(t):
    if isinstance(t, ADVTrainer):
        return (convert.opt_state_leaves(t.G_optim, t.models, G_TRAINED),
                convert.opt_state_leaves(t.D_optim, t.models, D_TRAINED))
    return tuple([np.asarray(x) for x in jax.tree.leaves(s)] for s in (t.G_state, t.D_state))


@pytest.mark.parametrize("index_key", ["valid_index", "eval_index"])
def test_three_steps_match_the_jax_trainer(config, trees, tmp_path, index_key):
    cfg = copy.deepcopy(config)
    cfg["adv"][index_key] = cfg["adv"].pop("valid_index")
    for name in ("jax", "port"):
        _adv_start(tmp_path, name, trees)
    jt = run(JADVTrainer(cfg, paras(jmake_paras, tmp_path, "jax")))
    pt = run(ADVTrainer(cfg, paras(make_paras, tmp_path, "port"), device="cpu"))
    assert jt.tr.step == pt.tr.step == 3
    for key in ("asr", "tae", "disc"):
        assert_trees_close(pt.tree(key), jax.tree.map(np.asarray, jt.params[key]), ATOL, key)
    # the TAE and the speller never move, bit for bit; the listener and D do
    for got, was in ((pt.tree("tae"), trees["tae"]),
                     ({k: v for k, v in pt.tree("asr").items() if k != "encoder"},
                      {k: v for k, v in trees["asr"].items() if k != "encoder"})):
        for g, w in zip(convert.tree_leaves(got), convert.tree_leaves(was)):
            np.testing.assert_array_equal(g, w)
    assert np.abs(pt.tree("disc")["fc1"]["w"] - trees["disc"]["fc1"]["w"]).max() > 0
    assert np.abs(pt.tree("asr")["encoder"]["blstm4"]["fwd"]["w_hh"]
                  - trees["asr"]["encoder"]["blstm4"]["fwd"]["w_hh"]).max() > 0
    runs = tmp_path / "runs"
    for key in ("adv_discrim_real_loss_train", "adv_discrim_fake_loss_train", "adv_gen_loss_train",
                "adv_discrim_loss_eval"):
        got_l = losses_of(runs / "port" / "adv" / "metrics.jsonl", key)
        assert len(got_l) >= 2
        np.testing.assert_allclose(got_l, losses_of(runs / "jax" / "adv" / "metrics.jsonl", key),
                                   rtol=1e-5)
    for fname in ("adv.npz", "asr.npz", "adv_best.npz"):
        assert_trees_close(ckpt.load_pytree(str(tmp_path / "result" / "port" / fname)),
                           jckpt.load_pytree(str(tmp_path / "result" / "jax" / fname)), ATOL, fname)
    for fname, n in (("adv_G_opt.npz", 3 + 2 * 24), ("adv_D_opt.npz", 4 + 2 * 6)):
        got_o = ckpt.load_opt_state(str(tmp_path / "result" / "port" / fname))
        want_o = ckpt.load_opt_state(str(tmp_path / "result" / "jax" / fname))
        assert len(got_o) == len(want_o) == n
        for g, w in zip(got_o, want_o):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_each_package_resumes_from_the_others_files(config, trees, tmp_path):
    cfg = copy.deepcopy(config)
    cfg["adv"]["valid_step"] = 1000
    for first, second, name in ((JADVTrainer, ADVTrainer, "jax_first"),
                                (ADVTrainer, JADVTrainer, "port_first")):
        _adv_start(tmp_path, name, trees)

        def make(cls):
            if cls is ADVTrainer:
                return cls(cfg, paras(make_paras, tmp_path, name), device="cpu")
            return cls(cfg, paras(jmake_paras, tmp_path, name))

        t = run(make(first))
        saved = (ckpt.load_opt_state(t.g_opt_ckppath), ckpt.load_opt_state(t.d_opt_ckppath))
        r = make(second)
        r.load_data()
        r.set_model()
        assert r.loaded_ckpt and r.tr.step == 3
        for got, want in zip(_opt_leaves(r), saved):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        assert int(saved[1][3]) == 3  # Adam's count sits before mu / nu
        r.exec()
        assert r.tr.step == 6
        r.close()
