"""The port's training stack against the JAX package's, on the CPU.

* The optimizer against optax's chain (``make_optimizer``: clip 5, then
  Adadelta / Adam / SGD under ``apply_if_finite``) over a sequence of
  gradients that holds a NaN step and a step whose norm is above 5: the
  parameters and every state leaf within 1e-6.
* ``ASRDataset`` batches equal the JAX package's, array for array.
* The trainer: at ``tf_rate: 1.0`` (no random number matters) the port's
  ``ASRTrainer`` and the JAX one start from one checkpoint on one corpus;
  after 3 steps their parameters agree within 1e-5 and their logged losses
  within rtol 1e-5.
* Checkpoints: each package resumes from the other's ``asr.npz`` +
  ``asr_opt.npz``.
* At tf 0.9 the port's loss falls on the tiny corpus, through
  ``python -m ss_asr_tpu_torch.cli.train ASRTrainer ... --device cpu``.
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from conftest import write_asr_corpus
from ss_asr_tpu.data.asr_dataset import ASRDataset as JASRDataset
from ss_asr_tpu.train import ASRTrainer as JASRTrainer
from ss_asr_tpu.train import make_paras as jmake_paras
from ss_asr_tpu.train.optim import make_optimizer
from ss_asr_tpu.utils import checkpoint as jckpt
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.data.asr_dataset import ASRDataset
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.train.asr_trainer import ASRTrainer
from ss_asr_tpu_torch.train.optim import Optimizer
from ss_asr_tpu_torch.train.solver import make_paras
from ss_asr_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TEXTS = ["já", "nei", "halló", "takk", "gott", "daginn", "kvöld", "morgunn",
         "góðan dag", "bless", "jæja", "hæ"]
MDL = {"encoder_state_size": 8, "mlp_out_size": 8, "decoder_state_size": 8,
       "tf_rate": 0.9, "feature_dim": 8}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("corpus")
    idx = write_asr_corpus(tmp, TEXTS, feature_dim=8)
    return {"asr": {
        "opt": {"type": "Adadelta", "learning_rate": 1.0}, "mdl": dict(MDL),
        "train_index": idx, "valid_index": idx, "wer_step": 1000, "t_bucket": 8,
        "l_bucket": 8, "train_batch_size": 4, "valid_batch_size": 5, "n_epochs": 1,
        "valid_step": 1000, "logging_step": 1, "save_step": 1000}}


def _paras(make, tmp_path, name):
    return make(name=name, logdir=str(tmp_path / "runs"), ckpdir=str(tmp_path / "result"),
                seed=1, verbose=False)


# --------------------------------------------------------------------------
# the optimizer


def _grad_sequence(rng, shapes):
    """Five gradient trees: small, one with a NaN, one of norm > 5, small, small."""
    seq = []
    for i in range(5):
        g = {k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
        if i == 1:
            g["b"][0, 1] = np.nan
        if i == 2:
            g = {k: 40.0 * v for k, v in g.items()}
        seq.append(g)
    return seq


@pytest.mark.parametrize("opt_type,lr", [("Adadelta", 1.0), ("Adam", 1e-3), ("SGD", 0.1)])
def test_optimizer_matches_optax(rng, opt_type, lr):
    shapes = {"a": (3, 4), "b": (2, 5), "c": (7,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tx = make_optimizer(opt_type, lr)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = Optimizer(sorted(tp.items()), opt_type, lr)
    taken = []
    for g in _grad_sequence(rng, shapes):
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        taken.append(opt.step())
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
        leaves = [opt.notfinite_count, opt.last_finite, opt.total_notfinite]
        leaves += [opt.count] if opt.opt_type == "adam" else []
        leaves += [opt.state[s][k] for s in opt.slots for k in sorted(shapes)]
        want = jax.tree.leaves(state)
        assert len(leaves) == len(want)
        for got, w in zip(leaves, want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert taken == [True, False, True, True, True]
    assert int(opt.total_notfinite) == 1 and bool(opt.last_finite)


# --------------------------------------------------------------------------
# data


def test_batches_equal_the_jax_package(corpus):
    c = corpus["asr"]
    for drop_last, bs in ((True, 4), (False, 5)):
        want = list(JASRDataset(c["train_index"], batch_size=bs, t_bucket=8, l_bucket=8)
                    .iter_batches(drop_last=drop_last))
        got = list(ASRDataset(c["train_index"], batch_size=bs, t_bucket=8, l_bucket=8)
                   .iter_batches(drop_last=drop_last))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            for field in ("x", "x_lens", "y", "y_lens", "valid"):
                a, b = getattr(g, field), getattr(w, field)
                assert (a is None) == (b is None), field
                if a is not None:
                    assert a.dtype == b.dtype, field
                    np.testing.assert_array_equal(a, b, err_msg=field)


# --------------------------------------------------------------------------
# the trainer


def _start(tmp_path, name, tree):
    d = tmp_path / "result" / name
    d.mkdir(parents=True)
    jckpt.save_pytree(str(d / "asr.npz"), tree)


def _losses(logdir):
    with open(logdir) as f:
        return [r["value"] for r in map(json.loads, f) if r["key"] == "asr_train_loss"]


def test_three_steps_match_the_jax_trainer(corpus, tmp_path):
    config = copy.deepcopy(corpus)
    config["asr"]["mdl"]["tf_rate"] = 1.0
    tree = convert.init_asr_numpy(3, las.ASRConfig(**config["asr"]["mdl"]))
    for name in ("jax", "port"):
        _start(tmp_path, name, tree)
    jt = JASRTrainer(config, _paras(jmake_paras, tmp_path, "jax"))
    pt = ASRTrainer(config, _paras(make_paras, tmp_path, "port"), device="cpu")
    for t in (jt, pt):
        t.load_data()
        t.set_model()
        t.exec()
    assert jt.tr.step == pt.tr.step == 3
    want = jax.tree.leaves(jax.tree.map(np.asarray, jt.params))
    got = convert.tree_leaves(pt.params_tree())
    assert len(got) == len(want) == 36
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    runs = tmp_path / "runs"
    np.testing.assert_allclose(_losses(runs / "port" / "asr" / "metrics.jsonl"),
                               _losses(runs / "jax" / "asr" / "metrics.jsonl"), rtol=1e-5)
    for t in (jt, pt):
        t.close()


def test_each_package_resumes_from_the_others_checkpoint(corpus, tmp_path):
    """One epoch (3 steps) in each package, then the other resumes: parameters and
    optimizer accumulators equal the files, and the step goes on."""
    config = copy.deepcopy(corpus)
    config["asr"]["mdl"]["tf_rate"] = 1.0
    config["asr"]["n_epochs"] = 1
    tree = convert.init_asr_numpy(4, las.ASRConfig(**config["asr"]["mdl"]))
    for writer, reader in ((JASRTrainer, ASRTrainer), (ASRTrainer, JASRTrainer)):
        name = f"{writer.__module__.split('.')[0]}_first"
        _start(tmp_path, name, tree)
        is_port = writer is ASRTrainer
        paras = _paras(make_paras if is_port else jmake_paras, tmp_path, name)
        t = writer(config, paras, device="cpu") if is_port else writer(config, paras)
        t.load_data()
        t.set_model()
        t.exec()
        t.close()
        saved = jckpt.load_pytree(t.ckppath)
        opt_leaves = ckpt.load_opt_state(t.opt_ckppath)
        is_port = reader is ASRTrainer
        paras = _paras(make_paras if is_port else jmake_paras, tmp_path, name)
        r = reader(config, paras, device="cpu") if is_port else reader(config, paras)
        r.load_data()
        r.set_model()
        assert r.loaded_ckpt and r.tr.step == 3
        if is_port:
            got_tree = r.params_tree()
            got_opt = convert.asr_opt_state_leaves(r.optim, r.model)
        else:
            got_tree = jax.tree.map(np.asarray, r.params)
            got_opt = [np.asarray(x) for x in jax.tree.leaves(r.opt_state)]
        for g, w in zip(convert.tree_leaves(got_tree), convert.tree_leaves(saved)):
            np.testing.assert_array_equal(g, w)
        assert len(got_opt) == len(opt_leaves) == 3 + 2 * 36
        for g, w in zip(got_opt, opt_leaves):
            np.testing.assert_array_equal(g, w)
        assert float(np.abs(opt_leaves[3 + 36]).max()) > 0  # e_x moved
        r.exec()
        assert r.tr.step == 6
        r.close()


def test_cli_train_loss_falls_at_tf_09(corpus, tmp_path):
    config = copy.deepcopy(corpus)
    config["asr"]["n_epochs"] = 8
    cfg_path = tmp_path / "conf.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    proc = subprocess.run(
        [sys.executable, "-m", "ss_asr_tpu_torch.cli.train", "ASRTrainer", "exp", str(cfg_path),
         str(tmp_path / "runs"), str(tmp_path / "result"), "--device", "cpu", "--verbose", "0"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    losses = _losses(tmp_path / "runs" / "exp" / "asr" / "metrics.jsonl")
    assert len(losses) == 24
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    d = tmp_path / "result" / "exp"
    assert (d / "asr.npz").exists() and (d / "asr_opt.npz").exists()
    assert json.loads((d / "tracker.json").read_text())["asr"]["step"] == 24


def test_cli_train_refuses_missing_cuda_and_dispatches_every_trainer(monkeypatch, tmp_path):
    from ss_asr_tpu_torch.cli import train
    from ss_asr_tpu_torch.train import lm_trainer, tester

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        train.main(["ASRTrainer"])
    calls = []

    def stub(name):
        class Stub:
            def __init__(self, config, paras, device):
                calls.append((name, paras.type, device, sorted(config)))

            def __getattr__(self, method):  # load_data, set_model, exec, close
                return lambda: calls.append(method)
        return Stub

    monkeypatch.setattr(lm_trainer, "CHARLMTrainer", stub("CHARLMTrainer"))
    monkeypatch.setattr(tester, "ASRTester", stub("ASRTester"))
    conf = str(ROOT / "conf" / "default.yaml")
    steps = ["load_data", "set_model", "exec", "close"]
    for kind, cls in (("LMTrainer", "CHARLMTrainer"), ("CHARLMTrainer", "CHARLMTrainer"),
                      ("ASRTester", "ASRTester")):
        calls.clear()
        train.main([kind, "exp", conf, str(tmp_path / "runs"), str(tmp_path / "result"),
                    "--device", "cpu"])
        assert calls[0][:3] == (cls, kind, "cpu") and "char_lm" in calls[0][3]
        assert calls[1:] == steps


def test_checkpoint_of_another_size_is_refused(corpus, tmp_path):
    _start(tmp_path, "size", convert.init_asr_numpy(0, las.ASRConfig(**{**MDL, "mlp_out_size": 4})))
    t = ASRTrainer(corpus, _paras(make_paras, tmp_path, "size"), device="cpu")
    with pytest.raises(ValueError, match="leaf attention/phi/w has shape"):
        t.set_model()


def test_keep_snapshots_prunes_to_the_newest(corpus, tmp_path):
    config = copy.deepcopy(corpus)
    config["asr"].update(keep_snapshots=2, save_step=1)
    t = ASRTrainer(config, _paras(make_paras, tmp_path, "snap"), device="cpu")
    t.load_data()
    t.set_model()
    t.exec()
    assert [s for s, _ in ckpt.list_snapshots(t.ckpdir, "asr")] == [1, 2]


@pytest.mark.parametrize("par,refused", [({"n_data": 2}, ValueError),
                                         ({"n_model": 2}, NotImplementedError),
                                         ({"n_data": "auto"}, None)])
def test_more_than_one_device_is_refused(corpus, tmp_path, par, refused):
    """One process asked for ``n_data: 2`` is told to launch 2 ranks;
    tensor parallelism stays left out; ``n_data: auto`` counts the ranks:
    one process trains alone (data parallelism: test_torch_dp.py)."""
    config = {**copy.deepcopy(corpus), "parallel": par}
    if refused is ValueError:
        with pytest.raises(ValueError, match="launch 2 ranks"):
            ASRTrainer(config, _paras(make_paras, tmp_path, "par"), device="cpu")
    elif refused is NotImplementedError:
        with pytest.raises(NotImplementedError, match="tensor parallelism"):
            ASRTrainer(config, _paras(make_paras, tmp_path, "par"), device="cpu")
    else:
        t = ASRTrainer(config, _paras(make_paras, tmp_path, "par"), device="cpu")
        assert t.tr.step == 0 and t.mesh is None
        t.load_data()
        t.set_model()
        t.exec()
        assert t.tr.step == len(t.train_ds) > 0
