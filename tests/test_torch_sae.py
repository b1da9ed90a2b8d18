"""The port's speech autoencoder and its trainer against the JAX package's.

* ``sae_forward`` in train and eval mode on the same numpy-seeded trees: the
  reconstruction within 1e-5, and after a train-mode forward the running
  statistics equal JAX's new state (momentum 0.1 on the BIASED batch
  variance, which ``nn.BatchNorm2d`` would not give) within 1e-6.
* The trainer's loss (pad-up / truncate alignment at a T that is no
  multiple of 8, ``t_valid = max(x_lens)``), the saturation telemetry and
  EVERY gradient of the joint {asr, sae} tree against ``jax.value_and_grad``:
  within 2e-5; the speller's gradient is zero in both.
* Three steps of the two ``SAETrainer``s from the same npz files, with and
  without ``listener_lr_scale``: losses (rtol 1e-5), parameters and running
  statistics (1e-5), the speller bit-unchanged, and each package resumes
  from the other's ``{"params", "bn_state"}`` checkpoint and optimizer state.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import write_asr_corpus
from ss_asr_tpu.models import las as jlas
from ss_asr_tpu.models import speech_autoencoder as jsae
from ss_asr_tpu.train import losses as jlosses
from ss_asr_tpu.train import make_paras as jmake_paras
from ss_asr_tpu.train.sae_trainer import SAETrainer as JSAETrainer
from ss_asr_tpu.utils import checkpoint as jckpt
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.models import speech_autoencoder as sae_mod
from ss_asr_tpu_torch.train.sae_trainer import TRAINED, SAETrainer
from ss_asr_tpu_torch.train.solver import make_paras
from ss_asr_tpu_torch.utils import checkpoint as ckpt
from test_torch_tae import (ASR_MDL, TEXTS, assert_trees_close, grad_tree, jnp_tree,
                            load_modules, losses_of, paras, run, start)

torch.set_num_threads(1)

SAE_MDL = {"kernel_sizes": [[1, 5], [5, 1], [3, 1]], "num_filters": [4, 6, 8],
           "pool_kernel_sizes": [[3, 1], [5, 1], [2000, 40]]}
FULL = {**SAE_MDL, "feature_dim": 8, "listener_out_dim": 16}
ATOL = 1e-5
GRAD_ATOL = 2e-5


def sae_module(params, bn_state):
    m = sae_mod.SpeechAutoencoder(sae_mod.SAEConfig.from_dict(FULL))
    m.load_state_dict(convert.sae_state_from_params(params, bn_state))
    return m


@pytest.fixture(scope="module")
def trees():
    params, bn = convert.init_sae_numpy(5, sae_mod.SAEConfig.from_dict(FULL))
    rng = np.random.default_rng(6)
    for i in (1, 2, 3):  # statistics and affine terms off their initial values
        n = bn[f"conv{i}"]["mean"].shape[0]
        bn[f"conv{i}"] = {"mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
                          "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
        params["encoder"][f"conv{i}"]["bn_scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        params["encoder"][f"conv{i}"]["bn_bias"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return convert.init_asr_numpy(3, las.ASRConfig(**ASR_MDL)), params, bn


def test_config_reads_the_reference_pool_as_global():
    for cfg in (sae_mod.SAEConfig.from_dict(FULL), sae_mod.SAEConfig()):
        assert cfg.pool_kernel_sizes[-1] == (-1, -1)
    assert sae_mod.SAEConfig.from_dict(FULL) == sae_mod.SAEConfig(
        **{k: getattr(jsae.SAEConfig.from_dict(FULL), k) for k in
           ("feature_dim", "listener_out_dim", "kernel_sizes", "num_filters",
            "pool_kernel_sizes", "frames_per_step")})


def test_trees_round_trip_through_the_state_dict(trees):
    _, params, bn = trees
    sd = convert.sae_state_from_params(params, bn)
    assert sd["encoder.conv_2.0.weight"].shape == (6, 4, 5, 1)  # OIHW from HWIO
    p2, bn2 = convert.sae_params_from_state(sd)
    for a, b in zip(convert.tree_leaves(p2) + convert.tree_leaves(bn2),
                    convert.tree_leaves(params) + convert.tree_leaves(bn)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_and_running_statistics_match_jax(rng, trees, train):
    _, params, bn = trees
    x = rng.standard_normal((3, 62, 8)).astype(np.float32)
    listener_out = rng.standard_normal((3, 7, 16)).astype(np.float32)
    want, new_bn = jsae.sae_forward(jnp_tree(params), jnp_tree(bn), jsae.SAEConfig.from_dict(FULL),
                                    jnp.asarray(x), jnp.asarray(listener_out), train=train)
    m = sae_module(params, bn)
    got = sae_mod.sae_forward(m, torch.from_numpy(x), torch.from_numpy(listener_out), train=train)
    assert got.shape == (3, 56, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    _, got_bn = convert.sae_params_from_state(m.state_dict())
    assert_trees_close(got_bn, new_bn, 1e-6, "bn_state")
    moved = any(np.abs(a - b).max() > 0 for a, b in
                zip(convert.tree_leaves(got_bn), convert.tree_leaves(bn)))
    assert moved == train


def _jax_recon_loss(asr_cfg, sae_cfg, bn_state, x, x_lens, train):
    """``SAETrainer.set_model``'s ``recon_loss``, which is local to it."""
    def recon_loss(params):
        listener_out, enc_lens = jlas.listener_apply(params["asr"]["encoder"], x, x_lens)
        recon, new_bn = jsae.sae_forward(params["sae"], bn_state, sae_cfg, x, listener_out,
                                         train=train)
        T = x.shape[1]
        recon = recon[:, :T, :]
        pad = T - recon.shape[1]
        if pad > 0:
            recon = jnp.pad(recon, ((0, 0), (0, pad), (0, 0)))
        t_valid = jnp.max(x_lens)
        valid = (jnp.arange(listener_out.shape[1])[None, :]
                 < jnp.maximum(enc_lens, 1)[:, None])[..., None]
        sat = jnp.sum((jnp.abs(listener_out) > 0.99) * valid) / jnp.maximum(
            jnp.sum(valid) * listener_out.shape[-1], 1)
        return jlosses.masked_smooth_l1_mean(recon, x, t_valid), (recon, new_bn, sat)

    return recon_loss


class _Step:
    """The port trainer's loss over given modules, without a Solver."""

    recon_loss = SAETrainer.recon_loss

    def __init__(self, asr, sae):
        self.models = {"asr": asr, "sae": sae}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_loss_and_every_gradient_match_jax(rng, trees, train):
    asr_tree, params, bn = trees
    x = (3.0 * rng.standard_normal((3, 62, 8))).astype(np.float32)  # both smooth-L1 branches
    x_lens = np.array([60, 50, 41], np.int32)
    for i, n in enumerate(x_lens):
        x[i, n:] = 0.0
    fn = _jax_recon_loss(jlas.ASRConfig(**ASR_MDL), jsae.SAEConfig.from_dict(FULL), jnp_tree(bn),
                         jnp.asarray(x), jnp.asarray(x_lens), train)
    (want, (recon_w, _, sat_w)), g = jax.value_and_grad(fn, has_aux=True)(
        {"asr": jnp_tree(asr_tree), "sae": jnp_tree(params)})
    (asr,) = load_modules(asr_tree)
    sae = sae_module(params, bn)
    loss, recon, sat = _Step(asr, sae).recon_loss(torch.from_numpy(x), torch.from_numpy(x_lens),
                                                  train)
    loss.backward()
    assert recon.shape == (3, 62, 8) and float(recon.detach()[:, 56:].abs().max()) == 0.0
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(recon_w), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(sat), float(sat_w), rtol=0, atol=1e-7)
    assert_trees_close(grad_tree("asr", asr), g["asr"], GRAD_ATOL, "asr")
    assert_trees_close(grad_tree("sae", sae), g["sae"], GRAD_ATOL, "sae")
    assert all(p.grad is None for n, p in asr.named_parameters() if not n.startswith("encoder"))
    assert float(np.abs(np.asarray(g["asr"]["encoder"]["pblstm1"]["fwd"]["w_ih"])).max()) > 0


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sae_corpus")
    idx = write_asr_corpus(tmp, TEXTS, feature_dim=8, t0=60, dt=2)
    return {"asr": {"mdl": dict(ASR_MDL)},
            "sae": {"opt": {"type": "Adadelta", "learning_rate": 1.0}, "mdl": dict(SAE_MDL),
                    "train_index": idx, "valid_index": idx, "t_bucket": 4, "l_bucket": 8,
                    "train_batch_size": 4, "valid_batch_size": 5, "n_epochs": 1,
                    "valid_step": 2, "logging_step": 1, "save_step": 1000}}


def _sae_start(tmp_path, name, trees):
    asr_tree, params, bn = trees
    start(tmp_path, name, asr=asr_tree, sae={"params": params, "bn_state": bn})


@pytest.mark.parametrize("lr_scale", [1.0, 0.25], ids=["plain", "listener_lr_scale"])
def test_three_steps_match_the_jax_trainer_and_leave_the_speller(config, trees, tmp_path,
                                                                 lr_scale):
    cfg = copy.deepcopy(config)
    cfg["sae"]["listener_lr_scale"] = lr_scale
    for name in ("jax", "port"):
        _sae_start(tmp_path, name, trees)
    jt = run(JSAETrainer(cfg, paras(jmake_paras, tmp_path, "jax")))
    pt = run(SAETrainer(cfg, paras(make_paras, tmp_path, "port"), device="cpu"))
    assert jt.tr.step == pt.tr.step == 3
    got = pt.sae_tree()
    assert_trees_close(got["params"], jax.tree.map(np.asarray, jt.params["sae"]), ATOL, "sae")
    assert_trees_close(got["bn_state"], jax.tree.map(np.asarray, jt.bn_state), ATOL, "bn_state")
    asr_got = convert.asr_params_from_state(pt.models["asr"].state_dict())
    assert_trees_close(asr_got, jax.tree.map(np.asarray, jt.params["asr"]), ATOL, "asr")
    asr_tree = trees[0]
    for key in ("attention", "decoder", "embed", "char_trans"):  # the speller: bit-unchanged
        for g, w in zip(convert.tree_leaves(asr_got[key]), convert.tree_leaves(asr_tree[key])):
            np.testing.assert_array_equal(g, w)
    assert np.abs(asr_got["encoder"]["blstm4"]["fwd"]["w_hh"]
                  - asr_tree["encoder"]["blstm4"]["fwd"]["w_hh"]).max() > 0
    runs = tmp_path / "runs"
    for key in ("sae_train_loss", "sae_eval_loss", "sae_listener_saturation"):
        got_l = losses_of(runs / "port" / "sae" / "metrics.jsonl", key)
        assert len(got_l) >= 2
        np.testing.assert_allclose(got_l, losses_of(runs / "jax" / "sae" / "metrics.jsonl", key),
                                   rtol=1e-5, atol=1e-7)
    for fname in ("sae.npz", "asr.npz", "sae_best.npz"):
        assert_trees_close(ckpt.load_pytree(str(tmp_path / "result" / "port" / fname)),
                           jckpt.load_pytree(str(tmp_path / "result" / "jax" / fname)), ATOL, fname)
    got_o, want_o = ckpt.load_opt_state(pt.opt_ckppath), ckpt.load_opt_state(jt.opt_ckppath)
    assert len(got_o) == len(want_o) == 3 + 2 * (24 + 15)  # the listener's 24, the SAE's 15
    for g, w in zip(got_o, want_o):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_each_package_resumes_from_the_others_files(config, trees, tmp_path):
    cfg = copy.deepcopy(config)
    cfg["sae"]["valid_step"] = 1000
    for first, second, name in ((JSAETrainer, SAETrainer, "jax_first"),
                                (SAETrainer, JSAETrainer, "port_first")):
        _sae_start(tmp_path, name, trees)

        def make(cls):
            if cls is SAETrainer:
                return cls(cfg, paras(make_paras, tmp_path, name), device="cpu")
            return cls(cfg, paras(jmake_paras, tmp_path, name))

        t = run(make(first))
        saved, saved_sae = ckpt.load_opt_state(t.opt_ckppath), ckpt.load_pytree(t.ckppath)
        r = make(second)
        r.load_data()
        r.set_model()
        assert r.loaded_ckpt and r.tr.step == 3
        if second is SAETrainer:
            got = convert.opt_state_leaves(r.optim, r.models, TRAINED)
            got_sae = r.sae_tree()
        else:
            got = [np.asarray(x) for x in jax.tree.leaves(r.opt_state)]
            got_sae = jax.tree.map(np.asarray, {"params": r.params["sae"], "bn_state": r.bn_state})
        assert len(got) == len(saved)
        for g, w in zip(got, saved):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(convert.tree_leaves(got_sae), convert.tree_leaves(saved_sae)):
            np.testing.assert_array_equal(g, w)
        r.exec()
        assert r.tr.step == 6
        r.close()
