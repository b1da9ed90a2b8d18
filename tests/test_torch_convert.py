"""Weights across the packages: JAX parameter trees -> the PyTorch port.

The port's state_dicts must carry exactly the reference key structure that
``ss_asr_tpu.utils.torch_import.export_asr`` / ``export_charlm`` write, with
the same values; the port's seeded numpy init must draw the JAX shapes; and
one npz checkpoint must load in both packages.
"""

import jax
import numpy as np
import pytest
import torch

from ss_asr_tpu.models import charlm as jcharlm
from ss_asr_tpu.models import las as jlas
from ss_asr_tpu.utils import checkpoint as jckpt
from ss_asr_tpu.utils import torch_import as ti
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.models import charlm, las
from ss_asr_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

TINY = dict(encoder_state_size=8, decoder_state_size=8, mlp_out_size=8, feature_dim=5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("sizes", [TINY, {}], ids=["tiny", "flagship"])
def test_asr_state_matches_export(sizes):
    tree = _np_tree(jlas.init_asr(jax.random.key(0), jlas.ASRConfig(**sizes)))
    want = ti.export_asr(tree)
    got = convert.asr_state_from_params(tree)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    model = las.LAS(las.ASRConfig(**sizes))
    assert set(model.state_dict()) == set(want)
    model.load_state_dict(got)  # strict: every key, every shape


@pytest.mark.parametrize("hidden", [8, 128])
def test_charlm_state_matches_export(hidden):
    tree = _np_tree(jcharlm.init_charlm(jax.random.key(1), jcharlm.CharLMConfig(hidden_size=hidden)))
    want = ti.export_charlm(tree)
    got = convert.charlm_state_from_params(tree)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    lm = charlm.CharLM(charlm.CharLMConfig(hidden_size=hidden))
    assert set(lm.state_dict()) == set(want)
    lm.load_state_dict(got)


@pytest.mark.parametrize("sizes", [TINY, {}], ids=["tiny", "flagship"])
def test_init_asr_numpy_has_the_jax_tree(sizes):
    want = jlas.init_asr(jax.random.key(0), jlas.ASRConfig(**sizes))
    got = convert.init_asr_numpy(3, las.ASRConfig(**sizes))
    assert jax.tree.structure(got) == jax.tree.structure(_np_tree(want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == np.float32
    # the speller's forget bias is 1.0, every other bias 0
    H = got["decoder"]["layer1"]["w_hh"].shape[0]
    for cell in ("layer1", "layer2"):
        b = got["decoder"][cell]["b"]
        assert np.all(b[H : 2 * H] == 1.0) and np.all(np.delete(b, np.s_[H : 2 * H]) == 0.0)
    assert np.all(got["encoder"]["pblstm1"]["fwd"]["b"] == 0.0)


def test_init_numpy_distributions():
    cfg = las.ASRConfig()
    tree = convert.init_asr_numpy(0, cfg)
    w = tree["decoder"]["layer1"]["w_ih"]  # lecun normal: std 1/sqrt(fan_in)
    assert abs(w.std() * np.sqrt(w.shape[0]) - 1.0) < 0.01
    assert abs(tree["embed"]["table"].std() - 1.0) < 0.05  # N(0, 1)
    lm = convert.init_charlm_numpy(0, charlm.CharLMConfig())
    bound = 1.0 / np.sqrt(128)
    for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
        a = lm["gru1"][k]
        assert a.min() >= -bound and a.max() <= bound and a.max() > 0.9 * bound
    want = jcharlm.init_charlm(jax.random.key(0), jcharlm.CharLMConfig())
    assert jax.tree.structure(lm) == jax.tree.structure(_np_tree(want))
    # seeded: the same seed gives the same tree
    again = convert.init_asr_numpy(0, cfg)
    np.testing.assert_array_equal(again["char_trans"]["w"], tree["char_trans"]["w"])


def test_npz_checkpoint_loads_in_both_packages(tmp_path):
    cfg = las.ASRConfig(**TINY)
    tree = convert.init_asr_numpy(0, cfg)
    ckpt.save_pytree(str(tmp_path / "port.npz"), tree)
    back = jckpt.load_pytree(str(tmp_path / "port.npz"))
    jax.tree.map(np.testing.assert_array_equal, back, tree)

    jtree = _np_tree(jlas.init_asr(jax.random.key(2), jlas.ASRConfig(**TINY)))
    jckpt.save_pytree(str(tmp_path / "jax.npz"), jtree)
    mine = ckpt.load_pytree(str(tmp_path / "jax.npz"))
    jax.tree.map(np.testing.assert_array_equal, mine, jtree)
    las.LAS(cfg).load_state_dict(convert.asr_state_from_params(mine))
