"""The port's mesh, batch sharding, collectives and sharded dataset
(``ss_asr_tpu_torch/parallel/mesh.py``, ``data/asr_dataset.py``) against
the JAX package's ``parallel/mesh.py`` and ``ASRDataset(host_shard=)``.

* ``make_mesh`` over an explicit device list (a repeated device splits rows
  on one device), its refusals, its (data, model) form; ``shard_batch``;
  ``pad_batch_to`` equal to JAX's.
* The collectives on two spawned gloo ranks (tests/torch_dp_workers.py):
  one flat all-reduce averages every gradient, a missing one as zeros, and
  the extras; the broadcast; the MIN / MAX step agreement; the ranks'
  bring-up from torchrun's environment.
* ``set_epoch`` and ``shard_index_rows``: for 3 epochs x 2 ranks, each
  rank's rows and the order in which it dispatches its batches equal the
  JAX package's.
* The solver's mesh: one process asked for more ranks than it is (data or
  tensor parallel) is told to launch them; ``n_data: 1`` trains bit for bit as no ``parallel:``
  section.
"""

import copy
import os

import numpy as np
import pytest
import torch

import torch_dp_workers as workers
from conftest import write_asr_corpus
from ss_asr_tpu.data.asr_dataset import ASRDataset as JASRDataset
from ss_asr_tpu.data.asr_dataset import shard_index_rows as jshard_index_rows
from ss_asr_tpu.parallel import mesh as jmesh
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.data.asr_dataset import ASRDataset, shard_index_rows
from ss_asr_tpu_torch.data.index import load_index
from ss_asr_tpu_torch.parallel import mesh as pmesh
from ss_asr_tpu_torch.train.asr_trainer import ASRTrainer
from ss_asr_tpu_torch.train.solver import make_paras, make_solver_mesh

torch.set_num_threads(1)

MDL = {"encoder_state_size": 8, "mlp_out_size": 8, "decoder_state_size": 8, "tf_rate": 0.9,
       "feature_dim": 8}


def test_make_mesh_over_a_device_list():
    m = pmesh.make_mesh(devices=["cpu"] * 8)
    assert m.shape == {"data": 8} and m.axis_names == ("data",)
    assert m.devices == (torch.device("cpu"),) * 8
    assert pmesh.make_mesh(n_data=3, devices=["cpu"] * 8).shape == {"data": 3}
    with pytest.raises(ValueError, match="mesh 9x1 > 8 devices"):
        pmesh.make_mesh(n_data=9, devices=["cpu"] * 8)
    tp = pmesh.make_mesh(n_data=4, n_model=2, devices=["cpu"] * 8)  # test_torch_tp.py
    assert tp.shape == {"data": 4, "model": 2} and tp.axis_names == ("data", "model")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.make_mesh()


def test_shard_batch_splits_rows_in_order():
    mesh = pmesh.make_mesh(devices=["cpu"] * 4)
    tree = {"x": np.arange(24, dtype=np.float32).reshape(8, 3), "lens": torch.arange(8)}
    shards = pmesh.shard_batch(tree, mesh)
    assert len(shards) == 4
    for i, s in enumerate(shards):
        np.testing.assert_array_equal(s["x"].numpy(), tree["x"][2 * i:2 * i + 2])
        assert s["lens"].tolist() == [2 * i, 2 * i + 1]
    with pytest.raises(ValueError, match="do not divide"):
        pmesh.shard_batch({"x": np.zeros((6, 2))}, mesh)


def test_pad_batch_to_matches_jax():
    tree = {"x": np.arange(12.0).reshape(3, 4), "y": np.arange(3)}
    for batch in (2, 3, 8):
        got, n = pmesh.pad_batch_to(tree, batch)
        want, jn = jmesh.pad_batch_to(tree, batch)
        assert n == jn
        for k in tree:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_collectives_on_two_gloo_ranks(tmp_path):
    r0, r1 = workers.run_ranks(workers.collectives, 2, tmp_path)
    for rank, r in enumerate((r0, r1)):
        assert (r["rank"], r["world"]) == (rank, 2)
        np.testing.assert_array_equal(r["grads"][0], np.full((2, 3), 15.0))
        np.testing.assert_array_equal(r["grads"][1], np.zeros(4))  # None on both: zeros
        np.testing.assert_array_equal(r["grads"][2], np.arange(5) / 2)  # None on rank 1
        assert r["loss"] == 0.5
        np.testing.assert_array_equal(r["extra"], np.full(3, 0.5))
        np.testing.assert_array_equal(r["bcast"][0], np.full(3, 7.0))  # rank 0's values
        np.testing.assert_array_equal(r["bcast"][1], np.zeros(2))
        assert (r["min"], r["max"]) == (3, 4)


def test_init_process_group_needs_torchrun_environment(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run --nproc-per-node"):
        pmesh.init_process_group("cpu")
    assert (pmesh.process_index(), pmesh.process_count()) == (0, 1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_index")
    texts = [f"orð {i} " + "a" * (i % 5) for i in range(11)]
    return write_asr_corpus(tmp, texts, feature_dim=8, t0=20, dt=3)


def test_shard_index_rows_match_jax(corpus):
    rows = load_index(corpus)
    frame = JASRDataset(corpus, batch_size=1).frame
    for host in range(3):
        got = [r["path_to_fbank"] for r in shard_index_rows(rows, host, 3)]
        assert got == list(jshard_index_rows(frame, host, 3)["path_to_fbank"])


def test_set_epoch_rotates_rows_and_dispatch_order_as_jax(corpus):
    """Each rank's rows and the order of its batches, 3 epochs x 2 ranks."""
    for host in range(2):
        ours = ASRDataset(corpus, batch_size=2, t_bucket=4, host_shard=(host, 2))
        theirs = JASRDataset(corpus, batch_size=2, t_bucket=4, host_shard=(host, 2))
        seen = set()
        for epoch in range(3):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert [r["path_to_fbank"] for r in ours.rows] == list(theirs.frame["path_to_fbank"])
            assert len(ours) == len(theirs)
            got = list(ours.iter_batches(prefetch=0))
            want = list(theirs.iter_batches(prefetch=0))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.y, w.y)
                np.testing.assert_array_equal(g.x, w.x)
                np.testing.assert_array_equal(g.x_lens, w.x_lens)
            seen.add(tuple(tuple(b.y[0]) for b in got))
        assert len(seen) > 1  # the dispatch order moved


def _config(idx, par=None):
    c = {"asr": {"opt": {"type": "Adadelta", "learning_rate": 1.0}, "mdl": dict(MDL),
                 "train_index": idx, "valid_index": idx, "t_bucket": 8, "l_bucket": 8,
                 "train_batch_size": 4, "valid_batch_size": 4, "n_epochs": 1,
                 "valid_step": 1000, "logging_step": 1000, "save_step": 1000,
                 "wer_step": 1000}}
    if par is not None:
        c["parallel"] = par
    return c


def test_solver_mesh_in_one_process(corpus):
    assert make_solver_mesh({}, "cpu") is None
    assert make_solver_mesh({"parallel": {"n_data": "auto"}}, "cpu") is None
    assert make_solver_mesh({"parallel": {"n_data": 1, "distributed": True}}, "cpu") is None
    with pytest.raises(ValueError, match="launch 4 ranks, python -m torch.distributed.run "
                                         "--nproc-per-node 4"):
        make_solver_mesh({"parallel": {"n_data": 4}}, "cpu")
    with pytest.raises(ValueError, match="n_data 1 x n_model 2 asks for 2 ranks, but this "
                                         "process runs alone: launch 2 ranks"):
        make_solver_mesh({"parallel": {"n_model": 2}}, "cpu")


def test_host_shard_by_hand_in_one_process(corpus, tmp_path):
    """``parallel: {host_shard: [r, n]}``: the shard without a process group;
    validation stays whole-corpus."""
    rows = []
    for host in range(2):
        t = ASRTrainer(_config(corpus, {"host_shard": [host, 2]}),
                       make_paras(name=f"h{host}", logdir=str(tmp_path / "runs"),
                                  ckpdir=str(tmp_path / "result"), verbose=False), device="cpu")
        t.load_data()
        assert t.host_shard == (host, 2) and t.mesh is None
        rows.append({r["path_to_fbank"] for r in t.train_ds.rows})
        assert len(t.valid_ds.rows) == 11
    assert not rows[0] & rows[1] and len(rows[0] | rows[1]) == 11


def test_n_data_one_is_bit_equal_to_no_parallel_section(corpus, tmp_path):
    """``n_data: 1`` takes today's single-process path: the same draws, the
    same updates, bit for bit (tf 0.9 and SpecAugment, so the draws count)."""
    trees = []
    for name, par in (("none", None), ("one", {"n_data": 1})):
        c = _config(corpus, par)
        c["asr"]["augment"] = {"n_freq_masks": 1, "freq_mask_width": 2, "n_time_masks": 1,
                               "time_mask_width": 4}
        c["asr"]["n_epochs"] = 2
        t = ASRTrainer(c, make_paras(name=name, logdir=str(tmp_path / "runs"),
                                     ckpdir=str(tmp_path / "result"), verbose=False),
                       device="cpu")
        t.load_data()
        t.set_model()
        t.exec()
        assert t.tr.step == 4
        trees.append(convert.tree_leaves(t.params_tree()))
    for a, b in zip(*trees):
        np.testing.assert_array_equal(a, b)
    assert not os.path.isdir(tmp_path / "runs" / "one" / "asr" / "rank0")
