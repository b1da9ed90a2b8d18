"""Tensor parallelism in the port (``parallel: {n_model: M > 1}``), on
spawned gloo ranks on the CPU (tests/torch_tp_workers.py), against the JAX
package and against the port's own single process.

* The sharding rules: ``param_pspec`` on JAX's four cases; for every leaf
  of a tiny LAS at ``n_model`` 2 and 4 the port's shard on model index m is
  the JAX leaf's block on model index m (``shard_params``); the ``(data,
  model)`` mesh's shape and rank layout.
* The ASR step at (2, 2) against the JAX ``ASRTrainer``'s ``tp_train_step``
  on 4 of the 8 CPU devices (tf 1.0, Adadelta, 2 steps, the same weights
  through ``convert``): losses and every gathered leaf within 1e-5
  relative (test_torch_dp.py's rule).
* At (1, 2) and (2, 2), tf 0.9 with SpecAugment and ``accum_steps: 2``,
  against one process on the joined batch: losses, leaves and the
  optimizer's leaves within 1e-5; every rank's gathered tree bit-equal;
  replicated leaves bit-equal on every rank, shards bit-equal across each
  data group and equal to their block of the gathered leaf.
* The trainer loop at (2, 2) against one process (train losses, two
  leaves and ``valid()``'s metrics within 1e-3, as
  ``tests/test_trainer_dp.py`` holds the JAX package's); a shared ckpdir
  written by rank 0 alone with full-width leaves, params and optimizer, and
  resumed by every rank.
* The TAE, SAE, ADV and char-LM trainers refuse ``n_model: 2`` as the JAX
  package's do; ``cli.train`` under ``torch.distributed.run
  --nproc-per-node 2`` at (1, 2).
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

import chip_smoke
import torch_dp_workers as workers
import torch_tp_workers as tp_workers
from conftest import write_asr_corpus
from ss_asr_tpu.parallel import mesh as jmesh
from ss_asr_tpu.train.asr_trainer import ASRTrainer as JASRTrainer
from ss_asr_tpu.train.solver import make_paras as jmake_paras
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.parallel import mesh as pmesh
from ss_asr_tpu_torch.train.asr_trainer import ASRTrainer
from ss_asr_tpu_torch.utils import checkpoint as ckpt
from test_torch_dp import (AUGMENT, MDL, RTOL, asr_config, assert_leaves_close,
                           assert_leaves_equal, batch, loop_config, paras, start)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
STEP_CASES = {  # name: (mdl, asr options, number of batches)
    "jax": ({}, {}, 2),
    "augment": ({"tf_rate": 0.9}, {"augment": AUGMENT}, 2),
    "accum": ({"tf_rate": 0.9}, {"opt": {"type": "Adadelta", "learning_rate": 1.0,
                                          "accum_steps": 2}}, 4),
}
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}


def _single_steps(config, tmp, name, batches):
    t = ASRTrainer(copy.deepcopy(config), paras(tmp, name), device="cpu")
    t.set_model()
    losses = [float(t.step(*(torch.from_numpy(a) for a in b))[0]) for b in batches]
    return losses, t.params_tree(), convert.asr_opt_state_leaves(t.optim, t.model)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The step cases at (1, 2) (two ranks) and (2, 2) (four ranks; with the
    trainer loops and the refusals in the same start-up), and one process
    on the joined batches."""
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    tree = convert.init_asr_numpy(3, las.ASRConfig(**MDL))
    cases, single = {}, {}
    for name, (mdl, opts, n) in STEP_CASES.items():
        config = asr_config(mdl, **copy.deepcopy(opts))
        batches = [batch(rng) for _ in range(n)]
        start(str(tmp), f"{name}_single", tree)
        single[name] = (*_single_steps(config, str(tmp), f"{name}_single", batches), batches)
        for key, (D, M) in MESHES.items():
            start(str(tmp), f"{name}_{key}", tree)
            cases.setdefault(key, []).append(
                ({**config, "parallel": {"n_data": D, "n_model": M}}, str(tmp), f"{name}_{key}",
                 batches))

    corpora = {}
    for name, texts in (("even", ["já", "nei", "halló", "takk", "gott", "daginn", "kvöld",
                                  "morgunn"]),
                        ("shared", ["já", "nei", "halló", "takk"])):
        d = tmp / name
        d.mkdir()
        corpora[name] = write_asr_corpus(d, texts, feature_dim=8, t0=24, dt=0, scale=0.1)
    loops = {"even": loop_config(corpora["even"], 4, 3),
             "shared": loop_config(corpora["shared"], 2, 2, save_step=1)}
    par = {"n_data": 2, "n_model": 2}
    common = {"train_index": corpora["shared"], "valid_index": corpora["shared"],
              "t_bucket": 8, "l_bucket": 8, "train_batch_size": 2, "valid_batch_size": 2}
    (tmp / "lm.txt").write_text("halló heimur þetta er texti\n" * 4, encoding="utf-8")
    adam = {"type": "Adam", "learning_rate": 1e-3}
    aux = {"asr": {"mdl": dict(MDL)}, "parallel": par,
           "tae": {"opt": dict(adam), "mdl": {"emb_dim": 6, "state_size": 8, "num_layers": 2},
                   "drop_rate": 0.2, **common},
           "sae": {"opt": dict(adam), "mdl": {"kernel_sizes": [[1, 5], [5, 1], [3, 1]],
                                              "num_filters": [4, 6, 8],
                                              "pool_kernel_sizes": [[3, 1], [5, 1], [2000, 40]]},
                   **common},
           "adv": {"G_opt": dict(adam), "D_opt": dict(adam), "mdl": {"hidden_dim": 12}, **common},
           "char_lm": {"opt": dict(adam), "mdl": {"hidden_size": 8},
                       "train_index": str(tmp / "lm.txt"), "chunk_size": 16,
                       "train_batch_size": 2}}
    ranks12 = workers.run_ranks(tp_workers.tp_steps, 2, tmp / "ranks12", cases["1x2"])
    ranks22 = workers.run_ranks(tp_workers.tp_run, 4, tmp / "ranks22", cases["2x2"],
                                str(tmp / "tp"),
                                {k: {**c, "parallel": dict(par)} for k, c in loops.items()}, aux)
    return {"steps": {"1x2": ranks12, "2x2": [r["steps"] for r in ranks22]},
            "single": single, "tree": tree, "loop_configs": loops,
            "loops": [r["loops"] for r in ranks22], "refusals": [r["refusals"] for r in ranks22],
            "tmp": str(tmp)}


def _case(tp, key, name):
    """Each rank's result of step case ``name`` on mesh ``key``."""
    return [r[list(STEP_CASES).index(name)] for r in tp["steps"][key]]


# --------------------------------------------------------------------------
# the sharding rules


def test_param_pspec_matches_jax():
    for shape, n in (((128, 64), 2), ((64,), 2), ((50, 7), 2), ((51, 7), 2), ((128, 64), 1),
                     ((8, 50), 4), ((50, 8), 4)):
        assert pmesh.param_pspec(shape, n) == tuple(jmesh.param_pspec(shape, n)), (shape, n)
    assert pmesh.param_pspec((128, 64), 2) == (None, "model")
    assert pmesh.param_pspec((64,), 2) == ()
    assert pmesh.param_pspec((50, 7), 2) == ("model", None)
    assert pmesh.param_pspec((51, 7), 2) == ()


@pytest.mark.parametrize("n_model", [2, 4])
def test_shard_params_match_jax(n_model):
    """Model index m's shard of every LAS leaf is the JAX leaf's block on
    model index m (``shard_params`` over a (1, M) mesh of CPU devices)."""
    tree = convert.init_asr_numpy(5, las.ASRConfig(**MDL))
    mesh = jmesh.make_mesh(n_data=1, n_model=n_model, devices=jax.devices()[:n_model])
    placed = jmesh.shard_params(jax.tree.map(jnp.asarray, tree), mesh)
    state = convert.asr_state_from_params(tree)
    tmesh = pmesh.make_mesh(1, n_model, ["cpu"] * n_model)
    specs = pmesh.param_shardings(state, tmesh)
    assert specs["encoder.blstm_1.layer.weight_ih_l0"] == ("model", None)  # JAX w_ih's 4H
    assert specs["embed.weight"] == (None, "model")  # the table is not transposed
    assert specs["decoder.layer_1.bias_ih"] == ()
    n_sharded = 0
    for m in range(n_model):
        ours = convert.asr_params_from_state(pmesh.shard_params(state, tmesh, m))
        for got, leaf in zip(convert.tree_leaves(ours), jax.tree.leaves(placed)):
            (want,) = [np.asarray(s.data) for s in leaf.addressable_shards
                       if s.device == mesh.devices[0, m]]
            np.testing.assert_array_equal(got, want)
            n_sharded += got.shape != leaf.shape
    assert n_sharded == n_model * 24  # every matrix of the 36 leaves (the 12 biases whole)


def test_make_mesh_data_by_model_layout():
    m = pmesh.make_mesh(n_data=4, n_model=2, devices=["cpu"] * 8)
    assert m.shape == {"data": 4, "model": 2} and m.axis_names == ("data", "model")
    devices = [torch.device("cuda", i) for i in range(8)]  # named only, never touched
    ours = pmesh.make_mesh(n_data=4, n_model=2, devices=devices)
    theirs = jmesh.make_mesh(n_data=4, n_model=2)
    assert [d.index for d in ours.devices] == [d.id for d in theirs.devices.reshape(-1)]
    assert [d.index for d in ours.data_devices] == [d.id for d in theirs.devices[:, 0]]
    assert pmesh.make_mesh(n_model=2, devices=devices).shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="mesh 4x3 > 8 devices"):
        pmesh.make_mesh(n_data=4, n_model=3, devices=devices)


# --------------------------------------------------------------------------
# the ASR step


def test_tp_step_matches_jax_tp_train_step(tp, tmp_path):
    """The JAX ASRTrainer at parallel {n_data: 2, n_model: 2}: jit + GSPMD
    over 4 of the 8 CPU devices, the leaves sharded by ``place_tp``."""
    got = _case(tp, "2x2", "jax")
    batches = tp["single"]["jax"][3]
    ckpt.save_pytree(str(tmp_path / "result" / "jax" / "asr.npz"), tp["tree"])
    config = {**asr_config(), "parallel": {"n_data": 2, "n_model": 2}}
    t = JASRTrainer(config, jmake_paras(name="jax", logdir=str(tmp_path / "runs"),
                                        ckpdir=str(tmp_path / "result"), verbose=False))
    t.set_model()
    assert dict(t.mesh.shape) == {"data": 2, "model": 2}
    want = []
    for x, xl, y in batches:
        b = t.place_batch({"x": x, "x_lens": xl, "y": y.astype(np.int32)})
        t.params, t.opt_state, loss, _ = t._train_step(t.params, t.opt_state, b["x"],
                                                       b["x_lens"], b["y"],
                                                       t.place_replicated(t.next_key()))
        want.append(float(loss))
    for r in got:
        np.testing.assert_allclose(r["losses"], want, rtol=RTOL)
        assert_leaves_close(convert.tree_leaves(r["tree"]),
                            jax.tree.leaves(jax.tree.map(np.asarray, t.params)))


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("name", ["augment", "accum"])
def test_tp_equals_one_process_on_the_joined_batch(tp, key, name):
    s_losses, s_tree, s_opt, _ = tp["single"][name]
    for r in _case(tp, key, name):
        np.testing.assert_allclose(r["losses"], s_losses, rtol=RTOL)
        assert_leaves_close(convert.tree_leaves(r["tree"]), convert.tree_leaves(s_tree))
        assert_leaves_close(r["opt"], s_opt)
        if name == "accum":  # 4 calls, 2 updates: mini_step back at 0
            assert int(r["opt"][3]) == 0 and int(r["opt"][4]) == 2


@pytest.mark.parametrize("key,name", [(k, n) for k in MESHES for n in STEP_CASES
                                      if (k, n) != ("1x2", "jax")])
def test_tp_ranks_bit_equal(tp, key, name):
    """Every rank's gathered tree and losses bit-equal; a replicated leaf
    bit-equal on every rank; a shard bit-equal across its data group and
    equal to its block of the gathered leaf."""
    rs = _case(tp, key, name)
    D, M = MESHES[key]
    mesh = pmesh.make_mesh(D, M, ["cpu"] * (D * M))
    state = convert.asr_state_from_params(rs[0]["tree"])  # bias_ih = b, bias_hh = 0
    specs = pmesh.param_shardings(state, mesh)
    for rank, r in enumerate(rs):
        assert r["coords"] == (rank // M, rank % M)
        assert r["host_shard"] == (rank // M, D)
        assert r["losses"] == rs[0]["losses"]
        assert_leaves_equal(convert.tree_leaves(r["tree"]), convert.tree_leaves(rs[0]["tree"]))
        assert_leaves_equal(r["opt"], rs[0]["opt"])
        assert set(r["shards"]) == {k for k in r["local"] if specs[k]}
        for k, v in r["local"].items():
            peer = rs[rank % M]  # data index 0, same model index
            np.testing.assert_array_equal(v, peer["local"][k])
            if not specs[k]:
                np.testing.assert_array_equal(v, rs[0]["local"][k])
            want = pmesh.local_slice(state[k], specs[k], mesh, {"model": rank % M})
            np.testing.assert_array_equal(v, want.numpy())
        assert r["bytes"]["gather"] > 0 and (r["bytes"]["reduce"] > 0) == (D > 1)


# --------------------------------------------------------------------------
# the trainer loop


def test_tp_exec_loop_matches_single_process(tp):
    """parallel {n_data: 2, n_model: 2} in the ASRTrainer.exec loop against
    one process on the global batch of 8, as the JAX package's
    test_tp_training_matches_single_device holds its own (rtol 1e-3)."""
    rs = [r["even"] for r in tp["loops"]]
    for r in rs[1:]:
        assert r["train_loss"] == rs[0]["train_loss"] and r["eval_loss"] == rs[0]["eval_loss"]
        assert_leaves_equal(convert.tree_leaves(r["params"]),
                            convert.tree_leaves(rs[0]["params"]))
    config = copy.deepcopy(tp["loop_configs"]["even"])
    config["asr"]["train_batch_size"] = 8
    t = ASRTrainer(config, paras(os.path.join(tp["tmp"], "single_loop"), "even"), device="cpu")
    logs = []
    t.lg.scalar = lambda k, v, s: logs.append((k, float(v)))
    t.lg.image = t.lg.text = lambda *a, **kw: None
    t.load_data()
    t.set_model()
    t.exec()
    t.valid()
    a = rs[0]
    assert len(a["train_loss"]) == 3
    np.testing.assert_allclose(a["train_loss"], [v for k, v in logs if k == "train_loss"],
                               rtol=1e-3)
    for k in ("eval_loss", "eval_acc", "eval_cer"):
        np.testing.assert_allclose(a[k], [v for n, v in logs if n == k], rtol=1e-3, err_msg=k)
    want = t.params_tree()
    for path in (("char_trans", "w"), ("encoder", "pblstm1", "fwd", "w_ih")):
        got, ref = a["params"], want
        for p in path:
            got, ref = got[p], ref[p]
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5)


def test_tp_shared_ckpdir_full_width_and_resume(tp):
    rs = [r["shared"] for r in tp["loops"]]
    assert [r["is_writer"] for r in rs] == [True, False, False, False]
    assert [r["rank_logs"] for r in rs] == [False, True, True, True]
    assert {"asr.npz", "asr_opt.npz", "tracker.json"} <= set(rs[0]["files"])
    for r in rs:
        assert r["step"] == r["resumed_step"] == 2 and r["loaded"]
        assert_leaves_equal(convert.tree_leaves(r["resumed"]), convert.tree_leaves(rs[0]["params"]))
    d = os.path.join(tp["tmp"], "tp", "result", "shared")
    cfg = las.ASRConfig(**MDL)
    full = convert.init_asr_numpy(0, cfg)
    saved = ckpt.load_pytree(os.path.join(d, "asr.npz"))
    assert [a.shape for a in convert.tree_leaves(saved)] == [
        a.shape for a in convert.tree_leaves(full)]
    assert saved["encoder"]["pblstm1"]["fwd"]["w_ih"].shape == (8, 32)  # 4H whole, not 16
    opt = ckpt.load_opt_state(os.path.join(d, "asr_opt.npz"))
    slots = [a.shape for a in opt[3:]]  # after the three NaN-skip counters: e_g, then e_x
    assert slots == [a.shape for a in convert.tree_leaves(full)] * 2
    with open(os.path.join(d, "tracker.json")) as f:
        assert json.load(f)["asr"]["step"] == 2


@pytest.mark.parametrize("kind", ["tae", "sae", "adv", "char_lm"])
def test_aux_trainers_refuse_tensor_parallelism(tp, kind):
    for r in tp["refusals"]:
        assert r[kind] == ("AssertionError", "parallel.n_model > 1 (tensor parallelism) is "
                           "supported by the ASR trainer; this model is too small to shard")


# --------------------------------------------------------------------------
# the CLI under torchrun


def test_cli_train_tp_under_torchrun_on_the_cpu(tmp_path):
    """``--nproc-per-node 2`` at (1, 2): both ranks train on every row and
    log the same losses; rank 0 writes full-width checkpoints."""
    idx = write_asr_corpus(tmp_path, [f"orð{i}" for i in range(6)], feature_dim=8, t0=24, dt=0,
                           scale=0.1)
    config = loop_config(idx, 2, 2)
    config["parallel"] = {"distributed": True, "n_data": "auto", "n_model": 2}
    cfg = tmp_path / "tp.yaml"
    cfg.write_text(yaml.safe_dump(config))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(chip_smoke.free_port()),
         "-m", "ss_asr_tpu_torch.cli.train", "ASRTrainer", "exp", str(cfg),
         str(tmp_path / "runs"), str(tmp_path / "result"), "--device", "cpu", "--verbose", "0"],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    losses = []
    for log in (tmp_path / "runs" / "exp" / "asr" / "metrics.jsonl",
                tmp_path / "runs" / "exp" / "asr" / "rank1" / "metrics.jsonl"):
        with open(log) as f:
            losses.append([r["value"] for r in map(json.loads, f) if r["key"] == "asr_train_loss"])
    # one data index: both ranks hold all 6 rows, 3 batches of 2 an epoch
    assert losses[0] == losses[1] and len(losses[0]) == 6
    with open(tmp_path / "result" / "exp" / "tracker.json") as f:
        assert json.load(f)["asr"]["step"] == 6
    saved = ckpt.load_pytree(str(tmp_path / "result" / "exp" / "asr.npz"))
    assert saved["char_trans"]["w"].shape == (8, 50)
    assert (tmp_path / "result" / "exp" / "asr_opt.npz").is_file()
