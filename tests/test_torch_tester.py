"""The port's ``ASRTester`` and its metrics against the JAX package's, on the CPU.

* ``char_acc_row``, ``with_terminal_eos``, ``err_rate`` and
  ``encode_texts`` equal the JAX functions on seeded rows.
* ``greedy_decode_early_exit`` (± LM) gives the tokens and lengths of JAX's
  ``greedy_decode``.
* ``ASRTester``: greedy ± LM and beam 3 ± LM, with and without
  ``max_decode_step_ratio``, on one checkpoint, LM and test index: the same
  ``decode_*`` file names, the same ``.txt`` bytes and the same
  ``_metrics.json`` as the JAX ``ASRTester``; without ``char_lm.npz`` both
  decode without fusion.
* ``python -m ss_asr_tpu_torch.cli.train ASRTester ... --device cpu``
  writes the same files.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from conftest import write_asr_corpus
from ss_asr_tpu.decode.greedy import greedy_decode as jgreedy_decode
from ss_asr_tpu.models import charlm as jcharlm
from ss_asr_tpu.models import las as jlas
from ss_asr_tpu.train import ASRTester as JASRTester
from ss_asr_tpu.train import make_paras as jmake_paras
from ss_asr_tpu.utils import checkpoint as jckpt
from ss_asr_tpu.utils import metrics as jmetrics
from ss_asr_tpu.vocab import Mapper as JMapper
from ss_asr_tpu.vocab import encode_texts as jencode_texts
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.data.asr_dataset import ASRDataset
from ss_asr_tpu_torch.decode.greedy import greedy_decode_early_exit
from ss_asr_tpu_torch.models import charlm, las
from ss_asr_tpu_torch.train.solver import make_paras
from ss_asr_tpu_torch.train.tester import ASRTester
from ss_asr_tpu_torch.utils import metrics
from ss_asr_tpu_torch.vocab import Mapper, encode_texts

torch.set_num_threads(1)

TEXTS = ["já", "nei", "halló", "takk", "gott", "daginn", "kvöld", "morgunn",
         "góðan dag", "bless", "jæja"]
MDL = {"encoder_state_size": 16, "mlp_out_size": 16, "decoder_state_size": 16, "tf_rate": 0.9,
       "feature_dim": 8}
LM_MDL = {"hidden_size": 8}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A test index, a seeded random ASR checkpoint whose greedy rows differ
    in length (some end at an EOS, some at the step cap), a random char-LM,
    and the tester's config."""
    tmp = tmp_path_factory.mktemp("tester")
    idx = write_asr_corpus(tmp, TEXTS, feature_dim=8, scale=3.0)
    config = {"asr": {"mdl": dict(MDL), "test_index": idx, "t_bucket": 8, "l_bucket": 8,
                      "test_batch_size": 4, "max_decode_steps": 24, "decode_beam_size": 1,
                      "decode_lm_weight": 0.5},
              "char_lm": {"mdl": dict(LM_MDL)}}
    asr_tree = convert.init_asr_numpy(3, las.ASRConfig(**MDL))
    lm_tree = convert.init_charlm_numpy(13, charlm.CharLMConfig(**LM_MDL))
    return tmp, config, asr_tree, lm_tree


def _write(tmp, name, asr_tree, lm_tree):
    d = tmp / "result" / name
    d.mkdir(parents=True, exist_ok=True)
    jckpt.save_pytree(str(d / "asr.npz"), asr_tree)
    if lm_tree is not None:
        jckpt.save_pytree(str(d / "char_lm.npz"), lm_tree)
    return d


def _paras(make, tmp, name):
    return make(name=name, logdir=str(tmp / "runs"), ckpdir=str(tmp / "result"), seed=1,
                verbose=False)


# --------------------------------------------------------------------------
# the metrics


def test_row_metrics_and_encode_texts_equal_the_jax_functions(rng):
    for _ in range(20):
        n = int(rng.integers(0, 9))
        label = np.concatenate([rng.integers(1, 50, size=n), np.zeros(int(rng.integers(0, 3)),
                                                                       int)]).astype(np.int32)
        pred = rng.integers(0, 50, size=int(rng.integers(0, 12))).astype(np.int32)
        assert metrics.char_acc_row(pred, label) == jmetrics.char_acc_row(pred, label)
        length = int(rng.integers(0, len(pred) + 1))
        np.testing.assert_array_equal(metrics.with_terminal_eos(pred, length),
                                      jmetrics.with_terminal_eos(pred, length))
    for hyp, ref in (("a b c", "a c"), ("", "abc"), ("abc", ""), ("halló heimur", "hallo heimur"),
                     ("x", "x")):
        for unit in ("word", "char"):
            assert metrics.err_rate(hyp, ref, unit) == jmetrics.err_rate(hyp, ref, unit)
    texts = ["<halló>", "<já>", "<góðan dag>"]
    for pad_to in (None, 5, 16):
        got = encode_texts(texts, Mapper(), pad_to)
        want = jencode_texts(texts, JMapper(), pad_to)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    m = Mapper()
    ids = m.encode("<halló>")
    assert m.decode(ids) == JMapper().decode(ids) == "<halló>"
    assert m.char_to_ind("h") == JMapper().char_to_ind("h")
    assert m.ind_to_char(7) == JMapper().ind_to_char(7)


@pytest.mark.parametrize("with_lm", [False, True], ids=["greedy", "greedy+lm"])
def test_greedy_early_exit_gives_the_tokens_and_lengths_of_jax_greedy(setup, with_lm):
    _, config, asr_tree, lm_tree = setup
    cfg = las.ASRConfig(**MDL)
    model = las.LAS(cfg)
    model.load_state_dict(convert.asr_state_from_params(asr_tree))
    lm = None
    if with_lm:
        lm = charlm.CharLM(charlm.CharLMConfig(**LM_MDL))
        lm.load_state_dict(convert.charlm_state_from_params(lm_tree))
    b = next(ASRDataset(config["asr"]["test_index"], batch_size=len(TEXTS), t_bucket=8)
             .iter_batches(drop_last=False))
    x, lens = b.x, b.x_lens
    with torch.inference_mode():
        toks, lengths = greedy_decode_early_exit(model.eval(), torch.from_numpy(x),
                                                 torch.from_numpy(lens), 24, lm, 0.5 * with_lm)
    jt, jl = jgreedy_decode(
        jax.tree.map(jnp.asarray, asr_tree), jlas.ASRConfig(**MDL), jnp.asarray(x),
        jnp.asarray(lens), 24, jax.tree.map(jnp.asarray, lm_tree) if with_lm else None,
        jcharlm.CharLMConfig(**LM_MDL), 0.5 * with_lm)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jl))
    if not with_lm:  # rows of both kinds: ended at an EOS, and at the step cap
        assert (lengths.numpy() < 24).any() and (lengths.numpy() == 24).any()


# --------------------------------------------------------------------------
# the tester


def _run_both(setup, tag, overrides, with_lm=True):
    tmp, config, asr_tree, lm_tree = setup
    config = copy.deepcopy(config)
    config["asr"].update(overrides)
    out = {}
    for pkg in ("jax", "port"):
        name = f"{tag}_{pkg}"
        _write(tmp, name, asr_tree, lm_tree if with_lm else None)
        if pkg == "jax":
            t = JASRTester(config, _paras(jmake_paras, tmp, name))
        else:
            t = ASRTester(config, _paras(make_paras, tmp, name), device="cpu")
        t.load_data()
        t.set_model()
        results = t.exec()
        t.close()
        d = tmp / "result" / name
        out[pkg] = (t.decode_file, results, (d / f"{t.decode_file}.txt").read_bytes(),
                    json.loads((d / f"{t.decode_file}_metrics.json").read_text()))
    return out


CASES = [
    ("greedy", {"decode_beam_size": 1, "decode_lm_weight": 0.0}, "decode_beam_1_lm0.0"),
    ("greedy_lm", {"decode_beam_size": 1}, "decode_beam_1_lm0.5"),
    ("beam3", {"decode_beam_size": 3, "decode_lm_weight": 0.0}, "decode_beam_3_lm0.0"),
    ("beam3_lm", {"decode_beam_size": 3}, "decode_beam_3_lm0.5"),
    ("greedy_lm_ratio", {"decode_beam_size": 1, "max_decode_step_ratio": 0.25},
     "decode_beam_1_len_0.25_lm0.5"),
    ("beam3_lm_ratio", {"decode_beam_size": 3, "max_decode_step_ratio": 0.25},
     "decode_beam_3_len_0.25_lm0.5"),
]


@pytest.mark.parametrize("tag,overrides,fname", CASES, ids=[c[0] for c in CASES])
def test_tester_writes_the_files_of_the_jax_tester(setup, tag, overrides, fname):
    out = _run_both(setup, tag, overrides)
    (jf, jres, jtxt, jm), (pf, pres, ptxt, pm) = out["jax"], out["port"]
    assert pf == jf == fname
    assert pres == jres and len(pres) == len(TEXTS)
    assert ptxt == jtxt
    assert pm == jm and pm["n"] == len(TEXTS)
    assert any(r for r in pres)  # not every hypothesis is empty


def test_tester_without_an_lm_decodes_without_fusion(setup, capsys):
    out = _run_both(setup, "nolm", {"decode_beam_size": 3}, with_lm=False)
    assert out["port"][2] == out["jax"][2] and out["port"][3] == out["jax"][3]
    fused = _run_both(setup, "nolm_ref", {"decode_beam_size": 3, "decode_lm_weight": 0.0})
    assert out["port"][2] == fused["port"][2]


def test_cli_train_asr_tester_writes_the_same_files(setup):
    from ss_asr_tpu_torch.cli import train

    tmp, config, asr_tree, lm_tree = setup
    config = copy.deepcopy(config)
    config["asr"].update(decode_beam_size=3, max_decode_step_ratio=0.25)
    path = tmp / "cli.yaml"
    path.write_text(yaml.safe_dump(config))
    _write(tmp, "cli", asr_tree, lm_tree)
    train.main(["ASRTester", "cli", str(path), str(tmp / "runs"), str(tmp / "result"),
                "--device", "cpu", "--verbose", "0"])
    want = _run_both(setup, "cli_ref", {"decode_beam_size": 3, "max_decode_step_ratio": 0.25})
    d = tmp / "result" / "cli"
    fname = "decode_beam_3_len_0.25_lm0.5"
    assert (d / f"{fname}.txt").read_bytes() == want["jax"][2]
    assert json.loads((d / f"{fname}_metrics.json").read_text()) == want["jax"][3]
    with open(tmp / "runs" / "cli" / "asr" / "metrics.jsonl") as f:
        keys = {r["key"] for r in map(json.loads, f)}
    assert {"asr_test_acc", "asr_test_wer", "asr_test_cer"} <= keys
