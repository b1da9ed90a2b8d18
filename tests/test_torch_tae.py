"""The port's text autoencoder and its trainer against the JAX package's.

* ``text_encode`` and ``tae_forward``: the same numpy-seeded trees and ids
  through both packages; memory and logits within 1e-5 (float32 sums in
  another order over a few LSTM steps).
* The loss (the unshifted-target quirk) and EVERY gradient of the joint
  {asr, tae} tree against ``jax.value_and_grad`` of the trainer's loss, with
  the JAX draws of a scheduled-sampling key injected: within 2e-5.  The
  listener's gradient is zero in both.
* ``tf_cutoff_last``: the JAX scan with the flag on and off gives identical
  logits and gradients (the flag only changes what is fed after the last
  step), so the port ignores it and still equals both.
* Three steps of the two ``TAETrainer``s from the same npz files at tf 1.0:
  every logged loss (rtol 1e-5) and every parameter (1e-5), the listener
  bit-unchanged, and each package resumes from the other's ``tae.npz`` /
  ``asr.npz`` / ``tae_opt.npz``.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import write_asr_corpus
from ss_asr_tpu.models import las as jlas
from ss_asr_tpu.models import text_autoencoder as jtae
from ss_asr_tpu.train import losses as jlosses
from ss_asr_tpu.train import make_paras as jmake_paras
from ss_asr_tpu.train.tae_trainer import TAETrainer as JTAETrainer
from ss_asr_tpu.utils import checkpoint as jckpt
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.models import text_autoencoder as tae_mod
from ss_asr_tpu_torch.train import losses
from ss_asr_tpu_torch.train.solver import make_paras
from ss_asr_tpu_torch.train.tae_trainer import TRAINED, TAETrainer
from ss_asr_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

TEXTS = ["já", "nei", "halló", "takk", "gott", "daginn", "kvöld", "morgunn",
         "góðan dag", "bless", "jæja", "hæ"]
ASR_MDL = {"encoder_state_size": 8, "mlp_out_size": 8, "decoder_state_size": 8,
           "tf_rate": 1.0, "feature_dim": 8}
TAE_MDL = {"emb_dim": 6, "state_size": 8, "num_layers": 2}
ATOL = 1e-5
GRAD_ATOL = 2e-5


def paras(make, tmp_path, name):
    return make(name=name, logdir=str(tmp_path / "runs"), ckpdir=str(tmp_path / "result"),
                seed=1, verbose=False)


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def load_modules(asr_tree=None, tae_tree=None):
    """The port's modules holding numpy trees (bias_hh frozen at zero)."""
    out = []
    if asr_tree is not None:
        m = las.LAS(las.ASRConfig(**ASR_MDL))
        m.load_state_dict(convert.asr_state_from_params(asr_tree))
        out.append(m)
    if tae_tree is not None:
        m = tae_mod.TextAutoencoder(tae_mod.TAEConfig(**TAE_MDL))
        m.load_state_dict(convert.tae_state_from_params(tae_tree))
        out.append(m)
    for m in out:
        for n, p in m.named_parameters():
            p.requires_grad_("bias_hh" not in n)
    return out


def grad_tree(key, module):
    """A module's gradients as the JAX tree of its model key (None -> zeros)."""
    sd = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
          for n, p in module.named_parameters()}
    return convert.PARAMS_FROM_STATE[key](sd)


def assert_trees_close(got, want, atol, what=""):
    got_l, want_l = convert.tree_leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(want)]
    for g, w, p in zip(got_l, want_l, paths):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol, err_msg=f"{what}{p}")


def losses_of(path, key):
    with open(path) as f:
        return [r["value"] for r in map(json.loads, f) if r["key"] == key]


def start(tmp_path, name, **trees):
    d = tmp_path / "result" / name
    d.mkdir(parents=True, exist_ok=True)
    for fname, tree in trees.items():
        jckpt.save_pytree(str(d / f"{fname}.npz"), tree)
    return d


def run(trainer, **set_model):
    trainer.load_data()
    trainer.set_model(**set_model)
    trainer.exec()
    trainer.close()
    return trainer


@pytest.fixture(scope="module")
def trees():
    return (convert.init_asr_numpy(3, las.ASRConfig(**ASR_MDL)),
            convert.init_tae_numpy(4, tae_mod.TAEConfig(**TAE_MDL)))


@pytest.fixture
def batch(rng):
    """y [3, 8] SOS-padded ids, a noised copy with texts of 1-2 characters,
    and the dataset's lengths (non-pad count + 1)."""
    y = np.zeros((3, 8), np.int32)
    yn = np.zeros((3, 8), np.int32)
    for i, (n, m) in enumerate(((6, 4), (3, 1), (5, 2))):
        y[i, 1 : n + 1] = rng.integers(3, 50, size=n)
        y[i, n + 1] = 1
        yn[i, 1 : m + 1] = y[i, 1 : m + 1]
        yn[i, m + 1] = 1
    return y, yn, ((yn != 0).sum(-1) + 1).astype(np.int32)


def test_text_encode_matches_jax_with_short_and_empty_rows(rng, trees):
    _, tae_tree = trees
    (tae,) = load_modules(tae_tree=tae_tree)
    ids = rng.integers(0, 50, size=(4, 7)).astype(np.int32)
    lens = np.array([7, 2, 1, 0], np.int32)
    want = jtae.text_encode(jnp_tree(tae_tree)["encoder"], jtae.TAEConfig(**TAE_MDL),
                            jnp.asarray(ids), jnp.asarray(lens))
    got = tae_mod.text_encode(tae.encoder, torch.from_numpy(ids), torch.from_numpy(lens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    full = tae_mod.text_encode(tae.encoder, torch.from_numpy(ids))
    want = jtae.text_encode(jnp_tree(tae_tree)["encoder"], jtae.TAEConfig(**TAE_MDL),
                            jnp.asarray(ids))
    np.testing.assert_allclose(full.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)


def _jax_loss(cutoff, asr_cfg, tae_cfg, y, yn, nl, key, tf):
    def loss_of(p):
        teacher = jnp.pad(y, ((0, 0), (0, 1)))
        memory = jtae.text_encode(p["tae"]["encoder"], tae_cfg, yn, nl)
        logits, _ = jlas.attend_and_spell(p["asr"], asr_cfg, memory, nl, y.shape[1],
                                          teacher=teacher, key=key, tf_rate=tf,
                                          tf_cutoff_last=cutoff)
        return jlosses.masked_ce_per_utt(logits, y, y), logits

    return loss_of


@pytest.mark.parametrize("tf", [1.0, 0.5])
def test_loss_logits_and_every_gradient_match_jax(trees, batch, tf):
    asr_tree, tae_tree = trees
    y, yn, nl = batch
    L, B = y.shape[1], y.shape[0]
    asr_cfg, tae_cfg = jlas.ASRConfig(**ASR_MDL), jtae.TAEConfig(**TAE_MDL)
    key = jax.random.key(7)
    params = {"asr": jnp_tree(asr_tree), "tae": jnp_tree(tae_tree)}
    jy, jyn, jnl = jnp.asarray(y), jnp.asarray(yn), jnp.asarray(nl)
    results = {}
    for cutoff in (True, False):
        results[cutoff] = jax.value_and_grad(
            _jax_loss(cutoff, asr_cfg, tae_cfg, jy, jyn, jnl, key, tf), has_aux=True)(params)
    # the flag changes nothing that is observed
    (l_on, logits_on), g_on = results[True]
    (l_off, logits_off), g_off = results[False]
    assert float(l_on) == float(l_off)
    np.testing.assert_array_equal(np.asarray(logits_on), np.asarray(logits_off))
    for a, b in zip(jax.tree.leaves(g_on), jax.tree.leaves(g_off)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and through the trainer's own forward (tae_forward sets the flag)
    _, logits_fwd = jtae.tae_forward(params["asr"], params["tae"], asr_cfg, tae_cfg,
                                     jnp.pad(jy, ((0, 0), (0, 1))), jyn, jnl, L, key, tf_rate=tf)
    np.testing.assert_array_equal(np.asarray(logits_fwd), np.asarray(logits_on))

    # the port, with the JAX draws injected
    k_tf, k_g = jax.random.split(key)
    tf_draws = np.asarray(jax.random.uniform(k_tf, (L,)) <= tf, np.float32)
    gumbel = np.asarray(jax.random.gumbel(k_g, (L, B, asr_cfg.vocab_size)))
    asr, tae = load_modules(asr_tree, tae_tree)
    ty = torch.from_numpy(y).long()
    _, logits = tae_mod.tae_forward(asr, tae, torch.nn.functional.pad(ty, (0, 1)),
                                    torch.from_numpy(yn).long(), torch.from_numpy(nl).long(), L,
                                    torch.from_numpy(tf_draws.copy()), torch.from_numpy(gumbel.copy()))
    loss = losses.masked_ce_per_utt(logits, ty, ty)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_on), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(loss.detach()), float(l_on), rtol=0, atol=ATOL)
    assert_trees_close(grad_tree("asr", asr), g_on["asr"], GRAD_ATOL, "asr")
    assert_trees_close(grad_tree("tae", tae), g_on["tae"], GRAD_ATOL, "tae")
    assert all(float(np.abs(np.asarray(g)).max()) == 0.0
               for g in jax.tree.leaves(g_on["asr"]["encoder"]))
    assert all(p.grad is None for p in asr.encoder.parameters())


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tae_corpus")
    idx = write_asr_corpus(tmp, TEXTS, feature_dim=8)
    return {"asr": {"mdl": dict(ASR_MDL)},
            "tae": {"opt": {"type": "Adadelta", "learning_rate": 1.0}, "mdl": dict(TAE_MDL),
                    "drop_rate": 0.3, "train_index": idx, "valid_index": idx, "l_bucket": 8,
                    "train_batch_size": 4, "valid_batch_size": 5, "n_epochs": 1,
                    "valid_step": 2, "logging_step": 1, "save_step": 1000}}


def test_noised_batches_equal_the_jax_package(config):
    from ss_asr_tpu.data.asr_dataset import ASRDataset as JASRDataset
    from ss_asr_tpu_torch.data.asr_dataset import ASRDataset

    c = config["tae"]
    for drop in (0.3, 0.0):
        kw = dict(batch_size=4, text_only=True, drop_rate=drop, l_bucket=8)
        want = list(JASRDataset(c["train_index"], **kw).iter_batches(drop_last=False))
        got = list(ASRDataset(c["train_index"], **kw).iter_batches(drop_last=False))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.x is None and g.x_lens is None
            for field in ("y", "y_lens", "y_noised", "y_noised_lens", "valid"):
                a, b = getattr(g, field), getattr(w, field)
                assert (a is None) == (b is None), field
                if a is not None:
                    assert a.dtype == b.dtype, field
                    np.testing.assert_array_equal(a, b, err_msg=field)


def test_three_steps_match_the_jax_trainer_and_leave_the_listener(config, trees, tmp_path):
    asr_tree, tae_tree = trees
    for name in ("jax", "port"):
        start(tmp_path, name, asr=asr_tree, tae=tae_tree)
    jt = run(JTAETrainer(config, paras(jmake_paras, tmp_path, "jax")))
    pt = run(TAETrainer(config, paras(make_paras, tmp_path, "port"), device="cpu"))
    assert jt.tr.step == pt.tr.step == 3
    for key in ("asr", "tae"):
        assert_trees_close(pt.tree(key), jax.tree.map(np.asarray, jt.params[key]), ATOL, key)
    # the listener never moves, bit for bit; the shared speller does
    for g, w in zip(convert.tree_leaves(pt.tree("asr")["encoder"]),
                    convert.tree_leaves(asr_tree["encoder"])):
        np.testing.assert_array_equal(g, w)
    assert np.abs(pt.tree("asr")["char_trans"]["w"] - asr_tree["char_trans"]["w"]).max() > 0
    runs = tmp_path / "runs"
    for key in ("tae_train_loss", "tae_eval_loss"):
        got = losses_of(runs / "port" / "tae" / "metrics.jsonl", key)
        assert len(got) >= 2
        np.testing.assert_allclose(got, losses_of(runs / "jax" / "tae" / "metrics.jsonl", key),
                                   rtol=1e-5)
    # the files: the same leaves in the same order, both ways
    for fname in ("tae.npz", "asr.npz", "tae_best.npz"):
        a = ckpt.load_pytree(str(tmp_path / "result" / "port" / fname))
        b = jckpt.load_pytree(str(tmp_path / "result" / "jax" / fname))
        assert_trees_close(a, b, ATOL, fname)
    got = ckpt.load_opt_state(pt.opt_ckppath)
    want = ckpt.load_opt_state(jt.opt_ckppath)
    assert len(got) == len(want) == 3 + 2 * (13 + 12)  # the TAE's 13 and the shared ASR subtrees' 12 leaves
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_each_package_resumes_from_the_others_files(config, trees, tmp_path):
    asr_tree, tae_tree = trees
    cfg = copy.deepcopy(config)
    cfg["tae"]["valid_step"] = 1000
    for first, second, name in ((JTAETrainer, TAETrainer, "jax_first"),
                                (TAETrainer, JTAETrainer, "port_first")):
        start(tmp_path, name, asr=asr_tree, tae=tae_tree)

        def make(cls):
            if cls is TAETrainer:
                return cls(cfg, paras(make_paras, tmp_path, name), device="cpu")
            return cls(cfg, paras(jmake_paras, tmp_path, name))

        t = run(make(first))
        saved = ckpt.load_opt_state(t.opt_ckppath)
        r = make(second)
        r.load_data()
        r.set_model()
        assert r.loaded_ckpt and r.tr.step == 3
        if second is TAETrainer:
            got = convert.opt_state_leaves(r.optim, r.models, TRAINED)
        else:
            got = [np.asarray(x) for x in jax.tree.leaves(r.opt_state)]
        assert len(got) == len(saved)
        for g, w in zip(got, saved):
            np.testing.assert_array_equal(g, w)
        assert float(np.abs(saved[3]).max()) > 0  # an accumulator moved
        r.exec()
        assert r.tr.step == 6
        r.close()
