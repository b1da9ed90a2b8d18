"""The Seed pipeline of the port, through ``cli.train Seed --device cpu`` on
an ``mkdata`` corpus preprocessed by the port, against the JAX package's.

* Stages [tae, adv, sae] (a subprocess) and [tae, sae] (in process), one
  super-iteration: every stage's files and the ASR relays ``asr_1 -> asr_2
  [-> asr_3]`` exist, each relay has the JAX package's tree (a JAX
  ``ASRTrainer`` loads the last one and validates on it), the listener is
  unchanged across the TAE stage and the speller across the later ones.
* A checkpoint directory written by one package's Seed run resumes in the
  other: every stage finds its checkpoint and optimizer state, and the
  trackers go on from the saved step.
* The two stage-order errors are raised.
"""

import copy
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from ss_asr_tpu.models import las as jlas
from ss_asr_tpu.train import ASRTrainer as JASRTrainer
from ss_asr_tpu.train import asr_seed_train as jasr_seed_train
from ss_asr_tpu.train import make_paras as jmake_paras
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.cli import mkdata, preprocess, train
from ss_asr_tpu_torch.train.seed import asr_seed_train
from ss_asr_tpu_torch.train.solver import make_paras
from ss_asr_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ASR_MDL = {"encoder_state_size": 8, "mlp_out_size": 8, "decoder_state_size": 8,
           "tf_rate": 0.9, "feature_dim": 40}
N_UTTS, BATCH = 12, 4
STEPS = N_UTTS // BATCH  # per stage and epoch


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seed_corpus")
    mkdata.main([str(tmp), "--n", str(N_UTTS), "--seed", "0"])
    preprocess.main(["generic", str(tmp / "processed"), str(tmp / "wav"), str(tmp / "txt"),
                     "--sr", "8000", "--device", "cpu"])
    idx = str(tmp / "processed" / "index.tsv")
    common = {"train_index": idx, "valid_index": idx, "t_bucket": 8, "l_bucket": 8,
              "train_batch_size": BATCH, "valid_batch_size": BATCH, "n_epochs": 1,
              "valid_step": 2, "logging_step": 1, "save_step": 1000}
    opt = {"type": "Adadelta", "learning_rate": 1.0}
    return {
        "asr": {**common, "opt": dict(opt), "mdl": dict(ASR_MDL), "wer_step": 1000},
        "tae": {**common, "opt": dict(opt), "drop_rate": 0.2,
                "mdl": {"emb_dim": 6, "state_size": 8, "num_layers": 2}},
        "sae": {**common, "opt": dict(opt),
                "mdl": {"kernel_sizes": [[1, 36], [5, 1], [3, 1]], "num_filters": [4, 6, 8],
                        "pool_kernel_sizes": [[3, 1], [5, 1], [2000, 40]]}},
        "adv": {**common, "G_opt": dict(opt), "D_opt": dict(opt), "mdl": {"hidden_dim": 12}},
        "seed_train": {"super_its": 1},
    }


def _write(tmp_path, config, stages):
    cfg = copy.deepcopy(config)
    cfg["seed_train"]["stages"] = stages
    path = tmp_path / "conf.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return cfg, str(path)


def _steps(d):
    return {k: v["step"] for k, v in json.loads((d / "tracker.json").read_text()).items()}


def _jax_loads(relay, config, tmp_path, name):
    """A JAX ``ASRTrainer`` starts from the relay and validates on it."""
    d = tmp_path / "result" / name
    d.mkdir(parents=True)
    shutil.copyfile(relay, d / "asr.npz")
    t = JASRTrainer(config, jmake_paras(name=name, logdir=str(tmp_path / "runs"),
                                        ckpdir=str(tmp_path / "result"), seed=1, verbose=False))
    t.load_data()
    t.set_model()
    assert t.loaded_ckpt
    want = jax.eval_shape(lambda k: jlas.init_asr(k, jlas.ASRConfig(**ASR_MDL)), jax.random.key(0))
    assert jax.tree.structure(t.params) == jax.tree.structure(want)
    t.valid()
    t.lg.close()
    assert np.isfinite(t.tr.get_best())


def _same(a, b, keys, equal=True):
    for key in keys:
        diffs = [np.abs(x - y).max() for x, y in zip(convert.tree_leaves(a[key]),
                                                     convert.tree_leaves(b[key]))]
        assert (max(diffs) == 0.0) == equal, key


SPELLER = ("attention", "decoder", "embed", "char_trans")


def test_cli_seed_tae_adv_sae_writes_the_relays_and_jax_continues(config, tmp_path):
    cfg, path = _write(tmp_path, config, ["tae", "adv", "sae"])
    proc = subprocess.run(
        [sys.executable, "-m", "ss_asr_tpu_torch.cli.train", "Seed", "exp", path,
         str(tmp_path / "runs"), str(tmp_path / "result"), "--device", "cpu", "--verbose", "0"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "Starting ADV training" in proc.stdout
    d = tmp_path / "result" / "exp"
    for name in ("asr_1.npz", "asr_2.npz", "asr_3.npz", "tae.npz", "tae_opt.npz", "adv.npz",
                 "adv_G_opt.npz", "adv_D_opt.npz", "sae.npz", "sae_opt.npz"):
        assert (d / name).is_file(), name
    assert _steps(d) == {"tae": STEPS, "adv": STEPS, "sae": STEPS}
    r1, r2, r3 = (ckpt.load_pytree(str(d / f"asr_{k}.npz")) for k in (1, 2, 3))
    _same(r1, r2, SPELLER)  # ADV and SAE move the listener only
    _same(r2, r3, SPELLER)
    _same(r1, r2, ("encoder",), equal=False)
    _same(r2, r3, ("encoder",), equal=False)
    _jax_loads(d / "asr_3.npz", cfg, tmp_path, "jax_from_relay")
    # the JAX package's Seed goes on in the same directory
    jasr_seed_train(cfg, jmake_paras(name="exp", logdir=str(tmp_path / "runs"),
                                     ckpdir=str(tmp_path / "result"), seed=1, verbose=False))
    assert _steps(d) == {"tae": 2 * STEPS, "adv": 2 * STEPS, "sae": 2 * STEPS}


def test_seed_tae_sae_after_a_jax_run_in_the_same_directory(config, tmp_path, capsys):
    cfg, path = _write(tmp_path, config, ["tae", "sae"])
    jasr_seed_train(cfg, jmake_paras(name="exp", logdir=str(tmp_path / "runs"),
                                     ckpdir=str(tmp_path / "result"), seed=1, verbose=False))
    d = tmp_path / "result" / "exp"
    assert _steps(d) == {"tae": STEPS, "sae": STEPS}
    before = {k: ckpt.load_pytree(str(d / f"asr_{k}.npz")) for k in (1, 2)}
    opt_before = ckpt.load_opt_state(str(d / "sae_opt.npz"))
    train.main(["Seed", "exp", path, str(tmp_path / "runs"), str(tmp_path / "result"),
                "--device", "cpu", "--verbose", "1"])
    out = capsys.readouterr().out
    assert out.count("Loading a pretrained model") == 4  # asr_1 + tae, asr_1 + sae
    assert out.count("Restoring optimizer state") == 2
    assert "Starting ADV training" not in out
    assert _steps(d) == {"tae": 2 * STEPS, "sae": 2 * STEPS}
    assert not (d / "asr_3.npz").exists()
    after = {k: ckpt.load_pytree(str(d / f"asr_{k}.npz")) for k in (1, 2)}
    _same(before[1], after[1], ("encoder",))  # the TAE stage leaves the listener
    _same(before[1], after[1], SPELLER, equal=False)
    _same(after[1], after[2], SPELLER)  # the SAE stage leaves the speller
    opt_after = ckpt.load_opt_state(str(d / "sae_opt.npz"))
    assert len(opt_after) == len(opt_before)
    assert all(a.shape == b.shape for a, b in zip(opt_after, opt_before))
    _jax_loads(d / "asr_2.npz", cfg, tmp_path, "jax_from_relay")


@pytest.mark.parametrize("stages,match", [(["tae", "gan"], "unknown stage"),
                                          (["adv", "tae"], "needs a 'tae' stage earlier"),
                                          (["sae", "adv"], "needs a 'tae' stage earlier")])
def test_stage_order_errors(config, tmp_path, stages, match):
    cfg, _ = _write(tmp_path, config, stages)
    with pytest.raises(ValueError, match=match):
        asr_seed_train(cfg, make_paras(name="exp", logdir=str(tmp_path / "runs"),
                                       ckpdir=str(tmp_path / "result"), verbose=False),
                       device="cpu")
    assert not list((tmp_path / "result").glob("exp/*.npz"))
