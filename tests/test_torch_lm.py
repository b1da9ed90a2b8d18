"""The port's char-LM stack against the JAX package's, on the CPU.

* ``LMDataset``: the chunks and batches of every epoch equal the JAX
  class's, with and without a host shard; ``make_split`` writes the same
  bytes.
* ``chunk_ce`` within 1e-6 of JAX's, relative (the loss is a sum near 50).
* ``generate``: at temperature 1e-4 (where the Gumbel noise cannot move an
  argmax) equal to JAX's ``charlm.generate``; at 0.8 with injected noise
  equal to a loop of JAX ``charlm.step`` calls fed the same noise.
* ``CHARLMTrainer``: 3 steps at ``tf_rate: 1.0`` (no random number
  matters) equal the JAX trainer's logged losses (rtol 1e-5) and
  parameters (1e-5); each package resumes from the other's ``char_lm.npz``
  + ``char_lm_opt.npz``; ``predict`` at tf 1.0 equals JAX's.
* The CLIs with ``--device cpu``: ``cli.train LMTrainer`` writes the JAX
  package's files, ``cli.generate`` at temperature 1e-4 prints what the JAX
  CLI prints, and ``cli.lm_predict`` prints the JAX CLI's probe line and
  tf 1.0 accuracy.
"""

import contextlib
import copy
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss_asr_tpu.data import lm_dataset as jlm_dataset
from ss_asr_tpu.models import charlm as jcharlm
from ss_asr_tpu.train import CHARLMTrainer as JCHARLMTrainer
from ss_asr_tpu.train import losses as jlosses
from ss_asr_tpu.train import make_paras as jmake_paras
from ss_asr_tpu.utils import checkpoint as jckpt
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.data import lm_dataset
from ss_asr_tpu_torch.models import charlm
from ss_asr_tpu_torch.train import losses
from ss_asr_tpu_torch.train.lm_trainer import CHARLMTrainer
from ss_asr_tpu_torch.train.solver import make_paras
from ss_asr_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

TEXT = "halló heimur þetta er texti\n" * 7  # 196 characters: 12 chunks of 16
H = 8


@pytest.fixture(scope="module")
def lm_config(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm") / "lm.txt"
    path.write_text(TEXT, encoding="utf-8")
    return {"char_lm": {
        "opt": {"type": "Adam", "learning_rate": 1e-3}, "mdl": {"hidden_size": H, "tf_rate": 1.0},
        "train_index": str(path), "chunk_size": 16, "train_batch_size": 4, "n_epochs": 1,
        "valid_step": 2, "logging_step": 1, "save_step": 1000}}


def _paras(make, tmp_path, name):
    return make(name=name, logdir=str(tmp_path / "runs"), ckpdir=str(tmp_path / "result"),
                seed=1, verbose=False)


def _lm(tree):
    lm = charlm.CharLM(charlm.CharLMConfig(hidden_size=H))
    lm.load_state_dict(convert.charlm_state_from_params(tree))
    return lm


def _tree(seed):
    return convert.init_charlm_numpy(seed, charlm.CharLMConfig(hidden_size=H))


# --------------------------------------------------------------------------
# data


@pytest.mark.parametrize("host_shard", [None, (0, 2), (1, 3)])
def test_lm_dataset_batches_equal_the_jax_package(host_shard):
    want = jlm_dataset.LMDataset(text=TEXT * 3, chunk_size=10, host_shard=host_shard)
    got = lm_dataset.LMDataset(text=TEXT * 3, chunk_size=10, host_shard=host_shard)
    assert got.get_num_chars() == want.get_num_chars() == 50
    np.testing.assert_array_equal(got.ids, want.ids)
    for epoch in range(4):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        assert len(got) == len(want) > 0
        np.testing.assert_array_equal(got.chunk_ids, want.chunk_ids)
        for shuffle in (True, False):
            gb = list(got.iter_batches(3, shuffle=shuffle, seed=epoch))
            wb = list(want.iter_batches(3, shuffle=shuffle, seed=epoch))
            assert len(gb) == len(wb) > 0
            for (gx, gy), (wx, wy) in zip(gb, wb):
                assert gx.dtype == wx.dtype == np.int32
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gy, wy)


def test_lm_dataset_reads_a_file_and_make_split_writes_the_same_bytes(tmp_path):
    src = tmp_path / "corpus.txt"
    src.write_text(TEXT + "ÆÐ!", encoding="utf-8")
    assert len(lm_dataset.load_lm_dataset(str(src), 16, 4)) == len(
        jlm_dataset.load_lm_dataset(str(src), 16, 4))
    for mod, tag in ((lm_dataset, "port"), (jlm_dataset, "jax")):
        mod.make_split(str(src), str(tmp_path / f"{tag}_train.txt"),
                       str(tmp_path / f"{tag}_eval.txt"), split=0.7)
    for part in ("train", "eval"):
        assert (tmp_path / f"port_{part}.txt").read_bytes() == \
            (tmp_path / f"jax_{part}.txt").read_bytes()


# --------------------------------------------------------------------------
# the loss and the model


def test_chunk_ce_matches_jax(rng):
    logits = (3 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    got = losses.chunk_ce(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jlosses.chunk_ce(jnp.asarray(logits), jnp.asarray(labels))
    # a sum over the chunk near 50: 1e-6 relative is a few float32 ulps
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("prompt", [None, "halló "])
def test_generate_at_low_temperature_matches_jax(prompt):
    tree = _tree(5)
    cfg = charlm.CharLMConfig(hidden_size=H)
    jcfg = jcharlm.CharLMConfig(hidden_size=H)
    from ss_asr_tpu_torch.vocab import Mapper

    ids = None if prompt is None else Mapper().encode(prompt)
    want = jcharlm.generate(jax.tree.map(jnp.asarray, tree), jcfg, jax.random.key(3), 40,
                            temp=1e-4, start_ids=None if ids is None else jnp.asarray(ids))
    got = charlm.generate(_lm(tree), cfg, torch.Generator().manual_seed(7), 40, temp=1e-4,
                          start_ids=None if ids is None else torch.from_numpy(ids))
    assert got.dtype == torch.int32 and got.shape == (40,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_with_injected_noise_matches_a_loop_of_jax_steps(rng):
    tree = _tree(6)
    jp = jax.tree.map(jnp.asarray, tree)
    jcfg = jcharlm.CharLMConfig(hidden_size=H)
    prompt = np.array([0, 10, 11, 12], np.int32)
    gumbel = -np.log(-np.log(rng.uniform(1e-6, 1.0, size=(30, 50)))).astype(np.float32)
    state = jcharlm.init_state(1, jcfg)
    for i in range(len(prompt) - 1):
        _, state = jcharlm.step(jp, jnp.asarray(prompt[i : i + 1]), state)
    ids, want = jnp.asarray(prompt[-1:]), []
    for t in range(30):
        logits, state = jcharlm.step(jp, ids, state)
        ids = jnp.argmax(logits / 0.8 + gumbel[t], axis=-1).astype(jnp.int32)
        want.append(int(ids[0]))
    got = charlm.generate(_lm(tree), charlm.CharLMConfig(hidden_size=H), None, 30, temp=0.8,
                          start_ids=torch.from_numpy(prompt), gumbel=torch.from_numpy(gumbel))
    assert got.tolist() == want
    assert len(set(want)) > 3  # the noise moved the samples off one argmax


def test_charlm_tree_round_trips_through_the_state_dict():
    tree = _tree(2)
    back = convert.charlm_params_from_state(_lm(tree).state_dict())
    assert convert.tree_leaves(back) and len(convert.tree_leaves(back)) == 11
    for g, w in zip(convert.tree_leaves(back), convert.tree_leaves(tree)):
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# the trainer


def _start(tmp_path, name, tree):
    d = tmp_path / "result" / name
    d.mkdir(parents=True)
    jckpt.save_pytree(str(d / "char_lm.npz"), tree)


def _losses(path):
    with open(path) as f:
        return [r["value"] for r in map(json.loads, f) if r["key"] == "char_lm_train_loss"]


def _pair(lm_config, tmp_path, tree, names=("jax", "port")):
    for name in names:
        _start(tmp_path, name, tree)
    jt = JCHARLMTrainer(lm_config, _paras(jmake_paras, tmp_path, names[0]))
    pt = CHARLMTrainer(lm_config, _paras(make_paras, tmp_path, names[1]), device="cpu")
    for t in (jt, pt):
        t.load_data()
        t.set_model()
    return jt, pt


def test_three_steps_match_the_jax_trainer(lm_config, tmp_path):
    jt, pt = _pair(lm_config, tmp_path, _tree(3))
    for t in (jt, pt):
        t.exec()
    assert jt.tr.step == pt.tr.step == 3
    want = jax.tree.leaves(jax.tree.map(np.asarray, jt.params))
    got = convert.tree_leaves(pt.params_tree())
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    runs = tmp_path / "runs"
    got_l = _losses(runs / "port" / "char_lm" / "metrics.jsonl")
    assert len(got_l) == 3
    np.testing.assert_allclose(got_l, _losses(runs / "jax" / "char_lm" / "metrics.jsonl"),
                               rtol=1e-5)
    for t in (jt, pt):
        assert (tmp_path / "result" / t.paras.name / "char_lm_best.npz").exists()
        t.close()
    want_opt = ckpt.load_opt_state(str(tmp_path / "result" / "jax" / "char_lm_opt.npz"))
    got_opt = ckpt.load_opt_state(str(tmp_path / "result" / "port" / "char_lm_opt.npz"))
    assert len(got_opt) == len(want_opt) == 4 + 2 * 11
    for g, w in zip(got_opt, want_opt):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_each_package_resumes_from_the_others_checkpoint(lm_config, tmp_path):
    tree = _tree(4)
    for writer, reader in ((JCHARLMTrainer, CHARLMTrainer), (CHARLMTrainer, JCHARLMTrainer)):
        is_port = writer is CHARLMTrainer
        name = f"{'port' if is_port else 'jax'}_first"
        _start(tmp_path, name, tree)
        paras = _paras(make_paras if is_port else jmake_paras, tmp_path, name)
        t = writer(lm_config, paras, device="cpu") if is_port else writer(lm_config, paras)
        t.load_data()
        t.set_model()
        t.exec()
        t.close()
        saved = jckpt.load_pytree(t.ckppath)
        opt_leaves = ckpt.load_opt_state(t.opt_ckppath)
        is_port = reader is CHARLMTrainer
        paras = _paras(make_paras if is_port else jmake_paras, tmp_path, name)
        r = reader(lm_config, paras, device="cpu") if is_port else reader(lm_config, paras)
        r.load_data()
        r.set_model()
        assert r.loaded_ckpt and r.tr.step == 3
        if is_port:
            got_tree = r.params_tree()
            got_opt = convert.opt_state_leaves(r.optim, r.models)
        else:
            got_tree = jax.tree.map(np.asarray, r.params)
            got_opt = [np.asarray(x) for x in jax.tree.leaves(r.opt_state)]
        for g, w in zip(convert.tree_leaves(got_tree), convert.tree_leaves(saved)):
            np.testing.assert_array_equal(g, w)
        assert len(got_opt) == len(opt_leaves) == 4 + 2 * 11
        for g, w in zip(got_opt, opt_leaves):
            np.testing.assert_array_equal(g, w)
        assert int(opt_leaves[3]) == 3 and float(np.abs(opt_leaves[4 + 11]).max()) > 0
        r.exec()
        assert r.tr.step == 6
        r.close()


def test_predict_at_tf_1_matches_jax(lm_config, tmp_path):
    jt, pt = _pair(lm_config, tmp_path, _tree(8))
    y = "alló heimur þetta"
    assert pt.predict("halló heimur þett", y, 1.0) == jt.predict("halló heimur þett", y, 1.0)
    assert 0 <= pt.predict("halló heimur þett", y, 0.5) <= 100


def test_trainer_warns_about_zero_batches_and_refuses_unported_options(lm_config, tmp_path,
                                                                      capsys):
    config = copy.deepcopy(lm_config)
    config["char_lm"]["train_batch_size"] = 64
    t = CHARLMTrainer(config, make_paras("zero", str(tmp_path / "runs"),
                                         str(tmp_path / "result"), 1, True), device="cpu")
    t.load_data()
    t.set_model()
    t.exec()
    assert "WARNING: 0 train batches" in capsys.readouterr().out and t.tr.step == 0
    config["char_lm"]["opt"]["warmup_steps"] = 5  # every option of the opt section is ported
    t = CHARLMTrainer(config, _paras(make_paras, tmp_path, "opt"), device="cpu")
    t.load_data()
    t.set_model()
    assert t.optim.scheduled and t.optim.rate() == 0.0


# --------------------------------------------------------------------------
# the CLIs


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_cli_train_generate_and_lm_predict_match_the_jax_clis(lm_config, tmp_path):
    import yaml

    from ss_asr_tpu.cli import generate as jgenerate
    from ss_asr_tpu.cli import lm_predict as jlm_predict
    from ss_asr_tpu_torch.cli import generate, lm_predict, train

    cfg_path = tmp_path / "conf.yaml"
    cfg_path.write_text(yaml.safe_dump(lm_config))
    for name in ("port", "jax"):
        _start(tmp_path, name, _tree(9))
    _run(train.main, ["LMTrainer", "port", str(cfg_path), str(tmp_path / "runs"),
                      str(tmp_path / "result"), "--device", "cpu", "--verbose", "0"])
    d = tmp_path / "result" / "port"
    for f in ("char_lm.npz", "char_lm_opt.npz", "char_lm_best.npz", "tracker.json"):
        assert (d / f).exists(), f
    assert json.loads((d / "tracker.json").read_text())["char_lm"]["step"] == 3
    # the JAX package's CLIs on the port's trained LM, and the port's
    jckpt.save_pytree(str(tmp_path / "result" / "jax" / "char_lm.npz"),
                      jckpt.load_pytree(str(d / "char_lm.npz")))
    common = ["--config", str(cfg_path), "--logdir", str(tmp_path / "runs"), "--ckpdir",
              str(tmp_path / "result"), "--verbose", "0"]
    gen = ["--start", "Halló  heimur ", "--length", "30", "--temp", "0.0001"]
    got = _run(generate.main, ["--name", "port", *common, *gen, "--device", "cpu"])
    want = _run(jgenerate.main, ["--name", "jax", *common, *gen])
    assert got == want and got.startswith("halló heimur ") and len(got) == 13 + 30 + 1
    probe = ["--text", "Halló heimur þetta er"]
    got = _run(lm_predict.main, ["--name", "port", *common, *probe, "--device", "cpu"]).split("\n")
    want = _run(jlm_predict.main, ["--name", "jax", *common, *probe]).split("\n")
    assert len(got) == len(want) == 13
    assert got[0] == want[0] == "alló heimur þetta er"
    assert got[-2] == want[-2] and got[-2].startswith("tf_rate=1: ")
    assert all(line.startswith(f"tf_rate={t}: ") and line.endswith("%")
               for line, t in zip(got[1:-1], [0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1]))
