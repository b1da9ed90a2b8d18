"""The trainers' options in the port against the JAX package's trainers, on
the CPU (the optimizer and the schedule alone: ``test_torch_options.py``).

* Three ``ASRTrainer`` updates (six micro-batches) with ``accum_steps: 2``, a
  warm-up / cosine schedule and ``asr.augment`` against the JAX trainer on the
  same weights, batches and augment draws (the JAX trainer's own key splits);
  the augment is seen to act: an unaugmented run ends elsewhere.
* Three micro-steps (one accumulated update, then half of the next) of each
  of the TAE, SAE (with ``listener_lr_scale``), ADV (G and D with sections of
  their own) and char-LM trainers against the JAX trainer: parameters,
  logged losses and the optimizer-state files, mid-accumulation.
"""

import copy

import jax
import numpy as np
import torch

from ss_asr_tpu.train import make_paras as jmake_paras
from ss_asr_tpu.utils import checkpoint as jckpt
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.models import text_autoencoder as tae_mod
from ss_asr_tpu_torch.train.solver import make_paras
from ss_asr_tpu_torch.utils import checkpoint as ckpt
from test_torch_options import SCHEDULE, _disc_cfg
from test_torch_tae import TAE_MDL, assert_trees_close, losses_of, paras, run

torch.set_num_threads(1)

ATOL = 1e-5  # the trainers' (tests/test_torch_{train,tae,sae,adv,lm}.py)


def _pair_run(jcls, pcls, cfg, tmp_path):
    jt = run(jcls(cfg, paras(jmake_paras, tmp_path, "jax")))
    pt = run(pcls(cfg, paras(make_paras, tmp_path, "port"), device="cpu"))
    assert jt.tr.step == pt.tr.step
    return jt, pt


def _assert_opt_files(tmp_path, fname, mini_step=1, gradient_step=1):
    got = ckpt.load_opt_state(str(tmp_path / "result" / "port" / fname))
    want = ckpt.load_opt_state(str(tmp_path / "result" / "jax" / fname))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    assert int(got[3]) == mini_step and int(got[4]) == gradient_step
    return got


def test_asr_trainer_with_accumulation_schedule_and_augment_matches_jax(tmp_path, monkeypatch):
    from conftest import write_asr_corpus
    from ss_asr_tpu.train import ASRTrainer as JASRTrainer
    from ss_asr_tpu_torch.ops import augment
    from ss_asr_tpu_torch.train.asr_trainer import ASRTrainer
    from test_torch_train import MDL, TEXTS

    idx = write_asr_corpus(tmp_path, TEXTS, feature_dim=8)
    aug = {"n_freq_masks": 2, "freq_mask_width": 3, "n_time_masks": 2, "time_mask_width": 4,
           "adaptive_size_ratio": 0.2}
    config = {"asr": {
        "opt": {"type": "Adadelta", "learning_rate": 1.0, "accum_steps": 2, **SCHEDULE},
        "mdl": {**MDL, "tf_rate": 1.0}, "augment": aug, "train_index": idx, "valid_index": idx,
        "wer_step": 1000, "t_bucket": 8, "l_bucket": 8, "train_batch_size": 4,
        "valid_batch_size": 5, "n_epochs": 2, "valid_step": 1000, "logging_step": 1,
        "save_step": 1000}}
    tree = convert.init_asr_numpy(3, las.ASRConfig(**config["asr"]["mdl"]))
    for name in ("jax", "port"):
        (tmp_path / "result" / name).mkdir(parents=True)
        jckpt.save_pytree(str(tmp_path / "result" / name / "asr.npz"), tree)
    jt = JASRTrainer(config, paras(jmake_paras, tmp_path, "jax"))
    jt.load_data()
    jt.set_model()
    # the JAX step's augment uniforms: next_key, then split(key)[0] is the augment's key,
    # split into (freq, time), each into (widths, starts)
    key, draws = jt._key, []
    for _ in range(6):
        key, k = jax.random.split(key)
        kf, kt = jax.random.split(jax.random.split(k)[0])
        step = []
        for kk, n in ((kf, aug["n_freq_masks"]), (kt, aug["n_time_masks"])):
            step += [np.asarray(jax.random.uniform(s, (4, n))) for s in jax.random.split(kk)]
        draws.append(step)
    jt.exec()
    jt.close()
    fed = []

    def jax_draws(B, cfg, generator, device):
        assert B == 4 and cfg == augment.SpecAugmentConfig(**aug)
        fed.append(draws[len(fed)])
        return tuple(torch.from_numpy(d) for d in fed[-1])

    monkeypatch.setattr(augment, "draw_uniforms", jax_draws)
    pt = run(ASRTrainer(config, paras(make_paras, tmp_path, "port"), device="cpu"))
    assert jt.tr.step == pt.tr.step == len(fed) == 6
    assert pt.optim.gradient_step == 3 and pt.optim.sched_count == 3
    want = jax.tree.leaves(jax.tree.map(np.asarray, jt.params))
    got = convert.tree_leaves(pt.params_tree())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    runs = tmp_path / "runs"
    np.testing.assert_allclose(losses_of(runs / "port" / "asr" / "metrics.jsonl", "asr_train_loss"),
                               losses_of(runs / "jax" / "asr" / "metrics.jsonl", "asr_train_loss"),
                               rtol=1e-5)
    leaves = _assert_opt_files(tmp_path, "asr_opt.npz", mini_step=0, gradient_step=3)
    assert len(leaves) == 5 + 2 * 36 + 1 + 36  # + the schedule's count + acc_grads
    # the augment really masked: an unaugmented run ends elsewhere
    clean = copy.deepcopy(config)
    del clean["asr"]["augment"]
    (tmp_path / "result" / "clean").mkdir(parents=True)
    jckpt.save_pytree(str(tmp_path / "result" / "clean" / "asr.npz"), tree)
    ct = run(ASRTrainer(clean, paras(make_paras, tmp_path, "clean"), device="cpu"))
    assert max(float(np.abs(a - b).max())
               for a, b in zip(convert.tree_leaves(ct.params_tree()), got)) > 1e-4


def test_tae_trainer_accumulated_step_matches_jax(tmp_path):
    from ss_asr_tpu.train.tae_trainer import TAETrainer as JTAETrainer
    from ss_asr_tpu_torch.train.tae_trainer import TAETrainer
    from test_torch_tae import start

    cfg, trees = _tae_config(tmp_path)
    for name in ("jax", "port"):
        start(tmp_path, name, asr=trees[0], tae=trees[1])
    jt, pt = _pair_run(JTAETrainer, TAETrainer, cfg, tmp_path)
    for key in ("asr", "tae"):
        assert_trees_close(pt.tree(key), jax.tree.map(np.asarray, jt.params[key]), ATOL, key)
    _assert_losses(tmp_path, "tae", ("tae_train_loss",))
    _assert_opt_files(tmp_path, "tae_opt.npz")


def _tae_config(tmp_path):
    from conftest import write_asr_corpus
    from test_torch_tae import ASR_MDL, TEXTS

    idx = write_asr_corpus(tmp_path, TEXTS, feature_dim=8)
    cfg = {"asr": {"mdl": dict(ASR_MDL)},
           "tae": {"opt": {"type": "Adadelta", "learning_rate": 1.0, "accum_steps": 2,
                           **SCHEDULE},
                   "mdl": dict(TAE_MDL), "drop_rate": 0.3, "train_index": idx,
                   "valid_index": idx, "l_bucket": 8, "train_batch_size": 4,
                   "valid_batch_size": 5, "n_epochs": 1, "valid_step": 1000, "logging_step": 1,
                   "save_step": 1000}}
    return cfg, (convert.init_asr_numpy(3, las.ASRConfig(**ASR_MDL)),
                 convert.init_tae_numpy(4, tae_mod.TAEConfig(**TAE_MDL)))


def _assert_losses(tmp_path, module, keys):
    runs = tmp_path / "runs"
    for key in keys:
        got = losses_of(runs / "port" / module / "metrics.jsonl", key)
        assert len(got) >= 3
        np.testing.assert_allclose(got, losses_of(runs / "jax" / module / "metrics.jsonl", key),
                                   rtol=1e-5, atol=1e-7)


def test_sae_trainer_accumulated_step_matches_jax(tmp_path):
    """With ``listener_lr_scale``: the update scale inside the accumulated chain."""
    from conftest import write_asr_corpus
    from ss_asr_tpu.train.sae_trainer import SAETrainer as JSAETrainer
    from ss_asr_tpu_torch.models import speech_autoencoder as sae_mod
    from ss_asr_tpu_torch.train.sae_trainer import SAETrainer
    from test_torch_sae import FULL, SAE_MDL
    from test_torch_tae import ASR_MDL, TEXTS, start

    idx = write_asr_corpus(tmp_path, TEXTS, feature_dim=8, t0=60, dt=2)
    cfg = {"asr": {"mdl": dict(ASR_MDL)},
           "sae": {"opt": {"type": "Adam", "learning_rate": 1e-3, "accum_steps": 2,
                           "decay_steps": 4, "end_scale": 0.2},
                   "mdl": dict(SAE_MDL), "listener_lr_scale": 0.25, "train_index": idx,
                   "valid_index": idx, "t_bucket": 4, "l_bucket": 8, "train_batch_size": 4,
                   "valid_batch_size": 5, "n_epochs": 1, "valid_step": 1000, "logging_step": 1,
                   "save_step": 1000}}
    params, bn = convert.init_sae_numpy(5, sae_mod.SAEConfig.from_dict(FULL))
    asr_tree = convert.init_asr_numpy(3, las.ASRConfig(**ASR_MDL))
    for name in ("jax", "port"):
        start(tmp_path, name, asr=asr_tree, sae={"params": params, "bn_state": bn})
    jt, pt = _pair_run(JSAETrainer, SAETrainer, cfg, tmp_path)
    got = pt.sae_tree()
    assert_trees_close(got["params"], jax.tree.map(np.asarray, jt.params["sae"]), ATOL, "sae")
    assert_trees_close(convert.asr_params_from_state(pt.models["asr"].state_dict()),
                       jax.tree.map(np.asarray, jt.params["asr"]), ATOL, "asr")
    _assert_losses(tmp_path, "sae", ("sae_train_loss",))
    _assert_opt_files(tmp_path, "sae_opt.npz")


def test_adv_trainer_accumulated_steps_match_jax(tmp_path):
    """G and D each with their own section: G accumulates 2 with a warm-up,
    D accumulates 3 with a cosine."""
    from conftest import write_asr_corpus
    from ss_asr_tpu.train.adv_trainer import ADVTrainer as JADVTrainer
    from ss_asr_tpu_torch.train.adv_trainer import ADVTrainer
    from test_torch_adv import DISC_MDL
    from test_torch_tae import ASR_MDL, TEXTS, start

    idx = write_asr_corpus(tmp_path, TEXTS, feature_dim=8)
    cfg = {"asr": {"mdl": dict(ASR_MDL)}, "tae": {"mdl": dict(TAE_MDL)},
           "adv": {"G_opt": {"type": "Adadelta", "learning_rate": 1.0, "accum_steps": 2,
                             "warmup_steps": 2},
                   "D_opt": {"type": "Adam", "learning_rate": 1e-3, "accum_steps": 3,
                             "decay_steps": 2},
                   "mdl": dict(DISC_MDL), "train_index": idx, "valid_index": idx,
                   "t_bucket": 8, "l_bucket": 8, "train_batch_size": 4, "valid_batch_size": 5,
                   "n_epochs": 1, "valid_step": 1000, "logging_step": 1, "save_step": 1000}}
    trees = {"asr": convert.init_asr_numpy(3, las.ASRConfig(**ASR_MDL)),
             "tae": convert.init_tae_numpy(4, tae_mod.TAEConfig(**TAE_MDL)),
             "disc": convert.init_disc_numpy(5, _disc_cfg())}
    for name in ("jax", "port"):
        start(tmp_path, name, asr=trees["asr"], tae=trees["tae"], adv=trees["disc"])
    jt, pt = _pair_run(JADVTrainer, ADVTrainer, cfg, tmp_path)
    for key in ("asr", "disc"):
        assert_trees_close(pt.tree(key), jax.tree.map(np.asarray, jt.params[key]), ATOL, key)
    _assert_losses(tmp_path, "adv", ("adv_discrim_loss_train", "adv_gen_loss_train"))
    _assert_opt_files(tmp_path, "adv_G_opt.npz")
    d = _assert_opt_files(tmp_path, "adv_D_opt.npz", mini_step=0)
    assert int(d[5]) == 1 and int(d[6 + 2 * 6]) == 1  # Adam's count, the schedule's


def test_charlm_trainer_accumulated_step_matches_jax(tmp_path):
    from ss_asr_tpu.train.lm_trainer import CHARLMTrainer as JCHARLMTrainer
    from ss_asr_tpu_torch.train.lm_trainer import CHARLMTrainer
    from test_torch_lm import TEXT, H, _start, _tree

    path = tmp_path / "lm.txt"
    path.write_text(TEXT, encoding="utf-8")

    cfg = {"char_lm": {
        "opt": {"type": "Adam", "learning_rate": 1e-3, "accum_steps": 2, **SCHEDULE},
        "mdl": {"hidden_size": H, "tf_rate": 1.0}, "train_index": str(path), "chunk_size": 16,
        "train_batch_size": 4, "n_epochs": 1, "valid_step": 1000, "logging_step": 1,
        "save_step": 1000}}
    for name in ("jax", "port"):
        _start(tmp_path, name, _tree(3))
    jt, pt = _pair_run(JCHARLMTrainer, CHARLMTrainer, cfg, tmp_path)
    assert pt.tr.step == 3
    for g, w in zip(convert.tree_leaves(pt.params_tree()),
                    jax.tree.leaves(jax.tree.map(np.asarray, jt.params))):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    _assert_losses(tmp_path, "char_lm", ("char_lm_train_loss",))
    _assert_opt_files(tmp_path, "char_lm_opt.npz")
