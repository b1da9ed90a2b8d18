"""Mesh serving in the port, the counterpart of ``tests/test_serve_mesh.py``:
``Transcriber(mesh=...)`` over a mesh of 8 repeated ``cpu`` devices splits
the rows over the data axis (5 rows: padded to 8 with zero-length rows)
and must equal both the port's single-device ``Transcriber`` and the JAX
package's mesh ``Transcriber`` on the same weights: greedy, a signal batch,
beam 3 (± the char-LM) and the batching server; n-best details equal the
single device's; a hot reload swaps every mesh device's pair at once; a
mesh without a ``data`` axis is refused.
"""

import jax
import numpy as np
import pytest
import torch

from ss_asr_tpu import api as japi
from ss_asr_tpu.models import charlm as jcharlm
from ss_asr_tpu.models import las as jlas
from ss_asr_tpu_torch import api, convert
from ss_asr_tpu_torch.models import charlm, las
from ss_asr_tpu_torch.parallel import mesh as pmesh
from ss_asr_tpu_torch.serve import BatchingTranscriber

torch.set_num_threads(1)

MDL = {"encoder_state_size": 8, "decoder_state_size": 8, "mlp_out_size": 8, "feature_dim": 40}
LM_MDL = {"hidden_size": 8}
KW = dict(max_steps=8, t_bucket=16, sr=8000)


def _models(seed, with_lm=False):
    cfg = las.ASRConfig(**MDL)
    tree = convert.init_asr_numpy(seed, cfg)
    model = las.LAS(cfg)
    model.load_state_dict(convert.asr_state_from_params(tree))
    lm = lm_tree = None
    if with_lm:
        lm_cfg = charlm.CharLMConfig(**LM_MDL)
        lm_tree = convert.init_charlm_numpy(seed + 1, lm_cfg)
        lm = charlm.CharLM(lm_cfg)
        lm.load_state_dict(convert.charlm_state_from_params(lm_tree))
    return model, lm, tree, lm_tree


def _three(seed=0, with_lm=False, **kw):
    """(the port's single-device, the port's mesh, JAX's mesh) Transcriber."""
    kw = {**KW, **kw}
    model, lm, tree, lm_tree = _models(seed, with_lm)
    single = api.Transcriber(model, lm=lm, **kw)
    mesh = api.Transcriber(model, lm=lm, mesh=pmesh.make_mesh(devices=["cpu"] * 8), **kw)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("data",))
    jt = japi.Transcriber(jax.tree.map(np.asarray, tree), jlas.ASRConfig(**MDL),
                          lm_params=lm_tree, lm_cfg=jcharlm.CharLMConfig(**LM_MDL) if with_lm
                          else None, mesh=jmesh, **kw)
    return single, mesh, jt


def test_mesh_greedy_matches_single_and_jax(rng):
    single, mesh, jt = _three()
    fbanks = [rng.standard_normal((10 + 2 * i, 40)).astype(np.float32) for i in range(5)]
    got = mesh.transcribe_fbank(list(fbanks))
    assert got == single.transcribe_fbank(list(fbanks)) == jt.transcribe_fbank(list(fbanks))
    assert len(got) == 5 and any(got)


def test_mesh_signal_batch_matches_single_and_jax(rng):
    single, mesh, jt = _three(seed=1)
    sigs = [0.1 * rng.standard_normal(n).astype(np.float32) for n in (3000, 4500, 6000)]
    got = mesh.transcribe_signal_batch(list(sigs), sr=8000)
    assert got == single.transcribe_signal_batch(list(sigs), sr=8000)
    assert got == jt.transcribe_signal_batch(list(sigs), sr=8000)


@pytest.mark.parametrize("with_lm", [False, True], ids=["beam3", "beam3+lm"])
def test_mesh_beam_matches_single_and_jax(rng, with_lm):
    single, mesh, jt = _three(seed=2, with_lm=with_lm, beam_size=3,
                              lm_weight=0.5 if with_lm else 0.0)
    fbanks = [rng.standard_normal((12 + 3 * i, 40)).astype(np.float32) for i in range(5)]
    got = mesh.transcribe_fbank(list(fbanks))
    assert got == single.transcribe_fbank(list(fbanks)) == jt.transcribe_fbank(list(fbanks))


def test_mesh_batching_server(rng):
    single, mesh, jt = _three(seed=3)
    fb = rng.standard_normal((14, 40)).astype(np.float32)
    with BatchingTranscriber(mesh, max_batch=4, max_wait_ms=100) as bt:
        futs = [bt.submit(fb) for _ in range(4)]
        got = [f.result(timeout=300) for f in futs]
    assert got == single.transcribe_fbank([fb] * 4) == jt.transcribe_fbank([fb] * 4)


def test_mesh_details_match_single(rng):
    single, mesh, _ = _three(seed=4, with_lm=True, beam_size=3, lm_weight=0.5)
    fbanks = [rng.standard_normal((16 + 4 * i, 40)).astype(np.float32) for i in range(5)]
    fbanks[2] = np.zeros((0, 40), np.float32)  # an empty row mid-batch
    got = mesh.transcribe_fbank_detailed(list(fbanks), n_best=2)
    want = single.transcribe_fbank_detailed(list(fbanks), n_best=2)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert [h.text for h in g] == [h.text for h in w]
        np.testing.assert_allclose([h.score for h in g], [h.score for h in w], rtol=1e-5)
        for hg, hw in zip(g, w):
            np.testing.assert_array_equal(hg.char_frames, hw.char_frames)


def test_reload_swaps_every_mesh_device_at_once(rng):
    _, mesh, _ = _three(seed=5)
    new_model = _models(6)[0]
    fbanks = [rng.standard_normal((12, 40)).astype(np.float32) for _ in range(3)]
    with BatchingTranscriber(mesh, max_batch=4, max_wait_ms=1) as bt:
        bt.reload_params(new_model.state_dict())
    model, lm, replicas = mesh._w
    assert len(replicas) == 8 and all(r == (model, lm) for r in replicas)
    for (a, b) in zip(model.state_dict().values(), new_model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert mesh.transcribe_fbank(fbanks) == api.Transcriber(new_model, **KW).transcribe_fbank(
        fbanks)


def test_mesh_requires_data_axis():
    model = _models(0)[0]
    with pytest.raises(ValueError, match="data"):
        api.Transcriber(model, mesh=pmesh.Mesh(["cpu"] * 8, axis_names=("model",)))
