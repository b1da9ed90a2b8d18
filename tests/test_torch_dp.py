"""Data-parallel training in the port, on two spawned gloo ranks on the CPU
(tests/torch_dp_workers.py), against the JAX package and against the
port's own single process.

* The ASR step against JAX's ``parallel.mesh.dp_train_step`` on a 2-device
  slice of the 8-CPU JAX mesh (tf 1.0, Adadelta, 2 steps, the same weights
  through ``convert``): losses and every parameter within 1e-5 relative
  (L2 over the leaf; a leaf of rounding noise, every element within 1e-7).
* Two ranks against one process on the joined batch: at tf 0.9 with
  SpecAugment (every rank draws the global batch's draws and keeps its
  rows) and with ``accum_steps: 2``: losses within 1e-5 relative, every
  parameter and optimizer leaf within 1e-5 relative L2; the ranks' states
  bit-equal.
* The trainer loop over two ranks, as ``tests/test_multiprocess.py`` holds
  the JAX package's: a one-bucket corpus at tf 1.0 equals one process on
  the global batch; 15 utterances at batch 4 (shards of 8 and 7) finish
  with the same step counts (the step cap); a shared ckpdir is written by
  rank 0 alone and both ranks resume from it.
* TAE, SAE, ADV and the char-LM: one step over two ranks against one
  process on the joined batch (the SAE: against two local forwards whose
  gradients and new running statistics are averaged, since its batch norm
  normalises with each rank's own statistics); then each loop, its step
  counts and states equal on both ranks.
* ``cli.train`` under ``python -m torch.distributed.run --nproc-per-node 2``
  with ``parallel: {distributed: true, n_data: auto}`` on the CPU.
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
from conftest import write_asr_corpus
from ss_asr_tpu.models import las as jlas
from ss_asr_tpu.parallel import mesh as jmesh
from ss_asr_tpu.train import losses as jlosses
from ss_asr_tpu.train.optim import make_optimizer
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.data.asr_dataset import ASRDataset
from ss_asr_tpu_torch.data.lm_dataset import LMDataset
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.train.adv_trainer import ADVTrainer
from ss_asr_tpu_torch.train.asr_trainer import ASRTrainer
from ss_asr_tpu_torch.train.lm_trainer import CHARLMTrainer
from ss_asr_tpu_torch.train.sae_trainer import SAETrainer
from ss_asr_tpu_torch.train.solver import make_paras
from ss_asr_tpu_torch.train.tae_trainer import TAETrainer
from ss_asr_tpu_torch.utils import checkpoint as ckpt
from ss_asr_tpu_torch.vocab import EOS_ID, VOCAB_SIZE

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MDL = {"encoder_state_size": 8, "mlp_out_size": 8, "decoder_state_size": 8, "tf_rate": 1.0,
       "feature_dim": 8}
AUGMENT = {"n_freq_masks": 1, "freq_mask_width": 2, "n_time_masks": 1, "time_mask_width": 4}
RTOL = 1e-5
ATOL = 1e-7
DP = {"n_data": "auto"}


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_leaves_close(got, want, tol=RTOL):
    """Each leaf within ``tol`` relative L2, or, for a leaf whose values are
    rounding noise (a gradient that cancels: attention biases move by
    1e-11), every element within ATOL."""
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.shape(g) == np.shape(w), i
        err = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).max(initial=0.0)
        assert rel_l2(g, w) <= tol or err <= ATOL, (i, rel_l2(g, w), err)


def assert_leaves_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def paras(tmp, name):
    return make_paras(name=name, logdir=os.path.join(tmp, "runs"),
                      ckpdir=os.path.join(tmp, "result"), seed=1, verbose=False)


def asr_config(mdl=None, **asr):
    return {"asr": {"opt": {"type": "Adadelta", "learning_rate": 1.0}, "mdl": {**MDL, **(mdl or {})},
                    **asr}}


def batch(rng, B=8, T=24, L=8):
    """A global batch: fbanks x [B, T, 8], lengths, targets y [B, L + 1]
    (SOS, characters, EOS, SOS padding)."""
    x = (0.5 * rng.standard_normal((B, T, 8))).astype(np.float32)
    x_lens = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    x_lens[0] = T
    y = np.zeros((B, L + 1), np.int64)
    for i, k in enumerate(rng.integers(2, L, size=B)):
        y[i, 1:k + 1] = rng.integers(3, VOCAB_SIZE, size=k)
        y[i, k + 1] = EOS_ID
    return x, x_lens, y


def start(tmp, name, tree):
    d = os.path.join(tmp, "result", name)
    os.makedirs(d, exist_ok=True)
    ckpt.save_pytree(os.path.join(d, "asr.npz"), tree)


# --------------------------------------------------------------------------
# the ASR step


STEP_CASES = {  # name: (mdl, asr options, number of batches)
    "jax": ({}, {}, 2),
    "augment": ({"tf_rate": 0.9}, {"augment": AUGMENT}, 2),
    "accum": ({"tf_rate": 0.9}, {"opt": {"type": "Adadelta", "learning_rate": 1.0,
                                          "accum_steps": 2}}, 4),
}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The three cases on two ranks, and the port's single process on the
    joined batches."""
    tmp = str(tmp_path_factory.mktemp("dp_steps"))
    rng = np.random.default_rng(0)
    tree = convert.init_asr_numpy(3, las.ASRConfig(**MDL))
    cases, single = [], {}
    for name, (mdl, opts, n) in STEP_CASES.items():
        config = asr_config(mdl, **copy.deepcopy(opts))
        batches = [batch(rng) for _ in range(n)]
        for who in ("dp", "single"):
            start(tmp, f"{name}_{who}", tree)
        cases.append(({**config, "parallel": dict(DP)}, tmp, f"{name}_dp", batches))
        t = ASRTrainer(copy.deepcopy(config), paras(tmp, f"{name}_single"), device="cpu")
        t.set_model()
        losses = [float(t.step(*(torch.from_numpy(a) for a in b))[0]) for b in batches]
        single[name] = (losses, t.params_tree(), convert.asr_opt_state_leaves(t.optim, t.model),
                        batches)
    r0, r1 = workers.run_ranks(workers.asr_steps, 2, os.path.join(tmp, "ranks"), cases)
    return {name: (r0[i], r1[i], single[name]) for i, name in enumerate(STEP_CASES)}, tree


def test_dp_step_matches_jax_dp_train_step(steps):
    """The JAX package's DP step: shard_map over a 2-device data axis, pmean
    of loss and gradients, optax's Adadelta under the clip and NaN skip."""
    results, tree = steps
    (losses, got_tree, _, _), _, (_, _, _, batches) = results["jax"]
    cfg = jlas.ASRConfig(**MDL)
    optim = make_optimizer("Adadelta", 1.0)

    def local_grads(params, x, x_lens, y, key):
        def loss_fn(p):
            _, logits, _ = jlas.asr_forward(p, cfg, x, x_lens, y.shape[1] - 1, teacher=y,
                                            key=key)
            return jlosses.masked_ce_per_utt(logits, y[:, 1:], y), logits

        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, grads, logits

    mesh = jmesh.make_mesh(n_data=2, devices=jax.devices()[:2])
    step = jmesh.dp_train_step(mesh, local_grads, optim, n_batch_args=3)
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = optim.init(params)
    want_losses = []
    for x, xl, y in batches:
        params, opt_state, loss, _ = step(params, opt_state, jnp.asarray(x), jnp.asarray(xl),
                                          jnp.asarray(y, jnp.int32), jax.random.key(0))
        want_losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL)
    assert_leaves_close(convert.tree_leaves(got_tree),
                        jax.tree.leaves(jax.tree.map(np.asarray, params)))


@pytest.mark.parametrize("name", ["augment", "accum"])
def test_two_ranks_equal_one_process_on_the_joined_batch(steps, name):
    (losses, tree, opt, _), _, (s_losses, s_tree, s_opt, _) = steps[0][name]
    np.testing.assert_allclose(losses, s_losses, rtol=RTOL)
    assert_leaves_close(convert.tree_leaves(tree), convert.tree_leaves(s_tree))
    assert_leaves_close(opt, s_opt)
    if name == "accum":  # 4 calls, 2 updates: mini_step back at 0, the running mean reset
        assert int(opt[3]) == 0 and int(opt[4]) == 2


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_the_ranks_stay_bit_equal(steps, name):
    (l0, t0, o0, _), (l1, t1, o1, _), _ = steps[0][name]
    assert l0 == l1
    assert_leaves_equal(convert.tree_leaves(t0), convert.tree_leaves(t1))
    assert_leaves_equal(o0, o1)


# --------------------------------------------------------------------------
# the trainer loop


def loop_config(idx, batch_size, n_epochs, **kw):
    c = asr_config(train_index=idx, valid_index=idx, t_bucket=8, l_bucket=16,
                   train_batch_size=batch_size, valid_batch_size=batch_size, n_epochs=n_epochs,
                   valid_step=10 ** 9, logging_step=1, save_step=10 ** 9, wer_step=10 ** 9)
    c["asr"].update(kw)
    return c


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_loops")
    corpora = {}
    for name, texts in (("even", ["já", "nei", "halló", "takk", "gott", "daginn", "kvöld",
                                  "morgunn"]),
                        ("uneven", [f"orð{i}" for i in range(15)]),
                        ("shared", ["já", "nei", "halló", "takk"])):
        d = tmp / name
        d.mkdir()
        # one length bucket: every rank's shard forms whole batches of its own
        corpora[name] = write_asr_corpus(d, texts, feature_dim=8, t0=24, dt=0, scale=0.1)
    configs = {"even": loop_config(corpora["even"], 4, 3),
               "uneven": loop_config(corpora["uneven"], 4, 3),
               "shared": loop_config(corpora["shared"], 2, 2, save_step=1)}
    dp = {k: {**copy.deepcopy(c), "parallel": dict(DP)} for k, c in configs.items()}
    r0, r1 = workers.run_ranks(workers.asr_loops, 2, tmp / "ranks", str(tmp / "dp"), dp)
    return r0, r1, configs, str(tmp)


def test_two_process_dp_matches_single_process(loops):
    r0, r1, configs, tmp = loops
    a, b = r0["even"], r1["even"]
    assert a["n_local_batches"] == b["n_local_batches"] == 1
    assert (a["host_shard"], b["host_shard"]) == ((0, 2), (1, 2))
    assert a["train_loss"] == b["train_loss"] and a["eval_loss"] == b["eval_loss"]
    assert a["eval_cer"] == b["eval_cer"]
    assert_leaves_equal(convert.tree_leaves(a["params"]), convert.tree_leaves(b["params"]))
    # one process over the same global batch (all 8 rows)
    config = copy.deepcopy(configs["even"])
    config["asr"]["train_batch_size"] = 8
    t = ASRTrainer(config, paras(os.path.join(tmp, "single"), "even"), device="cpu")
    logs = []
    t.lg.scalar = lambda k, v, s: logs.append((k, float(v)))
    t.lg.image = t.lg.text = lambda *a, **kw: None
    t.load_data()
    t.set_model()
    t.exec()
    t.valid()
    assert len(a["train_loss"]) == 3
    np.testing.assert_allclose(a["train_loss"], [v for k, v in logs if k == "train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(a["eval_loss"], [v for k, v in logs if k == "eval_loss"],
                               rtol=1e-4)
    assert_leaves_close(convert.tree_leaves(a["params"]), convert.tree_leaves(t.params_tree()),
                        1e-4)


def test_uneven_corpus_does_not_deadlock(loops):
    """Shards of 8 and 7 rows at batch 4 pack 2 and 1 batches: without the
    step cap rank 0 would wait in an all-reduce rank 1 never reaches."""
    r0, r1, _, _ = loops
    a, b = r0["uneven"], r1["uneven"]
    assert {a["n_local_batches"], b["n_local_batches"]} == {1, 2}
    assert a["step"] == b["step"] == 3 and len(a["train_loss"]) == len(b["train_loss"]) == 3
    assert a["train_loss"] == b["train_loss"]


def test_shared_ckpdir_is_written_by_rank_zero_and_resumed_by_both(loops):
    r0, r1, _, tmp = loops
    a, b = r0["shared"], r1["shared"]
    assert a["is_writer"] and not b["is_writer"]
    assert a["rank_logs"] is False and b["rank_logs"] is True  # runs/<name>/asr/rank1
    for f in ("asr.npz", "asr_opt.npz", "tracker.json"):
        assert f in a["files"]
    assert a["step"] == b["step"] == a["resumed_step"] == b["resumed_step"] == 2
    assert a["loaded"] and b["loaded"]
    for r in (a, b):
        assert_leaves_equal(convert.tree_leaves(r["resumed"]), convert.tree_leaves(a["params"]))
    with open(os.path.join(tmp, "dp", "result", "shared", "tracker.json")) as f:
        assert json.load(f)["asr"]["step"] == 2


# --------------------------------------------------------------------------
# the auxiliary trainers and the char-LM


TAE_MDL = {"emb_dim": 6, "state_size": 8, "num_layers": 2}
SAE_MDL = {"kernel_sizes": [[1, 5], [5, 1], [3, 1]], "num_filters": [4, 6, 8],
           "pool_kernel_sizes": [[3, 1], [5, 1], [2000, 40]]}
LM_TEXT = "halló heimur þetta er texti\n" * 9  # 15 chunks of 16: 7 a rank


@pytest.fixture(scope="module")
def aux(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_aux")
    texts = ["já", "nei", "halló", "takk", "gott", "daginn", "kvöld", "morgunn",
             "góðan dag", "bless", "jæja", "hæ"]
    idx = write_asr_corpus(tmp, texts, feature_dim=8, t0=60, dt=2)
    (tmp / "lm.txt").write_text(LM_TEXT, encoding="utf-8")
    common = {"train_index": idx, "valid_index": idx, "t_bucket": 8, "l_bucket": 8,
              "train_batch_size": 2, "valid_batch_size": 4, "n_epochs": 1, "valid_step": 2,
              "logging_step": 1, "save_step": 1000}
    adam = {"type": "Adam", "learning_rate": 1e-3}
    config = {
        "asr": {"mdl": {**MDL, "tf_rate": 0.9}},
        "tae": {"opt": dict(adam), "mdl": dict(TAE_MDL), "drop_rate": 0.2, **common},
        "sae": {"opt": {"type": "Adadelta", "learning_rate": 1.0}, "mdl": dict(SAE_MDL),
                **common},
        "adv": {"G_opt": {"type": "Adadelta", "learning_rate": 1.0}, "D_opt": dict(adam),
                "mdl": {"hidden_dim": 12}, **common},
        "char_lm": {"opt": dict(adam), "mdl": {"hidden_size": 8, "tf_rate": 0.9},
                    "train_index": str(tmp / "lm.txt"), "chunk_size": 16,
                    "train_batch_size": 2, "n_epochs": 1, "valid_step": 2,
                    "logging_step": 1, "save_step": 1000},
    }
    b = next(ASRDataset(idx, batch_size=4, t_bucket=8, l_bucket=8).iter_batches(prefetch=0))
    tb = next(ASRDataset(idx, batch_size=4, text_only=True, drop_rate=0.2,
                         l_bucket=8).iter_batches(prefetch=0))
    _, y_lm = next(LMDataset(str(tmp / "lm.txt"), 16).iter_batches(4, seed=0))
    batches = {"tae": (tb.y, tb.y_noised, tb.y_noised_lens), "sae": (b.x, b.x_lens),
               "adv": (b.x, b.x_lens, b.y, b.y_lens), "char_lm": (y_lm,)}
    r0, r1 = workers.run_ranks(workers.aux_runs, 2, tmp / "ranks", str(tmp / "dp"),
                               {**config, "parallel": dict(DP)}, batches)
    return r0, r1, config, batches, str(tmp)


def _single(cls, config, tmp, name):
    t = cls(copy.deepcopy(config), paras(tmp, name), device="cpu")
    t.lg.scalar = t.lg.image = t.lg.text = t.lg.embedding = lambda *a, **kw: None
    t.load_data()
    t.set_model()
    return t


def _tree_leaves(trees):
    return [x for k in sorted(trees) for x in convert.tree_leaves(trees[k])]


@pytest.mark.parametrize("kind", ["tae", "adv", "char_lm"])
def test_aux_step_over_two_ranks_equals_one_process(aux, kind):
    r0, r1, config, batches, tmp = aux
    cls = {"tae": TAETrainer, "adv": ADVTrainer, "char_lm": CHARLMTrainer}[kind]
    t = _single(cls, config, os.path.join(tmp, "single"), kind)
    b = [torch.from_numpy(np.asarray(a)) for a in batches[kind]]
    if kind == "tae":
        want = t.step(b[0].long(), b[1].long(), b[2].long())[0]
    elif kind == "adv":
        want = torch.stack([*t.d_step(b[0], b[1], b[2].long(), b[3].long()), t.g_step(b[0], b[1])])
    else:
        want = t.step(b[0].long())[0]
    np.testing.assert_allclose(r0[kind]["loss"], want.numpy(), rtol=RTOL)
    trees = {k: t.tree(k) for k in t.models} if hasattr(t, "models") else {
        "char_lm": t.params_tree()}
    assert_leaves_close(_tree_leaves(r0[kind]["step_trees"]), _tree_leaves(trees))
    for r in (r0, r1):
        assert r[kind]["loop_step"] == 3  # 6 rows a rank, batches of 2 (the LM: 7 chunks)
    np.testing.assert_array_equal(r0[kind]["loss"], r1[kind]["loss"])
    for phase in ("step_trees", "loop_trees"):
        assert_leaves_equal(_tree_leaves(r0[kind][phase]), _tree_leaves(r1[kind][phase]))


def test_sae_averages_the_ranks_running_statistics(aux):
    """Each rank normalises with its own batch's statistics; the gradients
    and the NEW running statistics are averaged (the JAX package's
    ``pmean(new_bn)``): one process running each rank's half and averaging
    gives the same step."""
    r0, r1, config, batches, tmp = aux
    halves = [_single(SAETrainer, config, os.path.join(tmp, "single"), f"sae{r}")
              for r in range(2)]
    x, xl = (torch.from_numpy(np.asarray(a)) for a in batches["sae"])
    losses = []
    for r, t in enumerate(halves):
        t.zero_grad()
        loss, _, _ = t.recon_loss(x[2 * r:2 * r + 2], xl[2 * r:2 * r + 2], True)
        loss.backward()
        losses.append(float(loss.detach()))
    a, b = halves
    for pa, pb in zip(a.optim.params.values(), b.optim.params.values()):
        ga = pa.grad if pa.grad is not None else torch.zeros_like(pa)
        gb = pb.grad if pb.grad is not None else torch.zeros_like(pb)
        pa.grad = (ga + gb) / 2
    with torch.no_grad():
        for sa, sb in zip(a.models["sae"].buffers(), b.models["sae"].buffers()):
            sa.copy_((sa + sb) / 2)
    a.optim.step()
    np.testing.assert_allclose(float(r0["sae"]["loss"]), np.mean(losses), rtol=RTOL)
    want = {"asr": a.tree("asr"), "sae": a.sae_tree()}
    assert_leaves_close(_tree_leaves(r0["sae"]["step_trees"]), _tree_leaves(want))
    bn = r0["sae"]["step_trees"]["sae"]["bn_state"]
    for k in bn:  # the running statistics moved off their start, to the average
        assert not np.allclose(bn[k]["mean"], 0.0)
    assert r0["sae"]["loop_step"] == r1["sae"]["loop_step"] == 3
    for phase in ("step_trees", "loop_trees"):
        assert_leaves_equal(_tree_leaves(r0["sae"][phase]), _tree_leaves(r1["sae"][phase]))


# --------------------------------------------------------------------------
# the CLI under torchrun


def test_cli_train_under_torchrun_on_the_cpu(tmp_path):
    """Two ranks through ``python -m torch.distributed.run``: rank 0 writes
    the checkpoints, both take the same steps, each logs its losses."""
    idx = write_asr_corpus(tmp_path, [f"orð{i}" for i in range(9)], feature_dim=8, t0=24, dt=0,
                           scale=0.1)
    config = loop_config(idx, 2, 2)
    config["parallel"] = {"distributed": True, "n_data": "auto"}
    cfg = tmp_path / "dp.yaml"
    cfg.write_text(yaml.safe_dump(config))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(chip_smoke.free_port()),
         "-m", "ss_asr_tpu_torch.cli.train", "ASRTrainer", "exp", str(cfg),
         str(tmp_path / "runs"), str(tmp_path / "result"), "--device", "cpu", "--verbose", "0"],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    logs = [tmp_path / "runs" / "exp" / "asr" / "metrics.jsonl",
            tmp_path / "runs" / "exp" / "asr" / "rank1" / "metrics.jsonl"]
    losses = []
    for log in logs:
        with open(log) as f:
            losses.append([r["value"] for r in map(json.loads, f) if r["key"] == "asr_train_loss"])
    # shards of 5 and 4 rows at batch 2: 2 steps an epoch on both ranks (the cap)
    assert losses[0] == losses[1] and len(losses[0]) == 4
    with open(tmp_path / "result" / "exp" / "tracker.json") as f:
        assert json.load(f)["asr"]["step"] == 4
    assert (tmp_path / "result" / "exp" / "asr_opt.npz").is_file()
