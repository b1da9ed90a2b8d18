"""The port's ``cli.pseudolabel`` and ``cli.avg_ckpt`` against the JAX CLIs, on the CPU.

* ``pseudolabel`` on one checkpoint and one set of tone wavs (``mkdata``,
  resampled 8 -> 16 kHz; an unreadable file and two wavs with one stem
  among them), greedy and beam 3 + LM, at a confidence floor that keeps
  every hypothesis and at one that splits them: the same summary line, the
  same ``index.tsv`` rows (texts, frame counts, confidences, stems) and
  fbanks by ``test_torch_preprocess``'s rule for tone corpora; the kept
  rows load through ``ASRDataset``.
* ``average_pytrees`` equals the JAX function (float64 accumulation, the
  dtype cast back) and raises the same ``ValueError`` for an empty list, a
  key-set mismatch and a shape mismatch; ``cli.avg_ckpt`` over explicit
  paths and over ``--ckpdir --module --last`` writes the JAX CLI's file,
  and refuses what it refuses.
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from ss_asr_tpu.cli import avg_ckpt as javg_ckpt
from ss_asr_tpu.cli import pseudolabel as jpseudolabel
from ss_asr_tpu.utils import checkpoint as jckpt
from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.cli import avg_ckpt, mkdata, pseudolabel
from ss_asr_tpu_torch.data.asr_dataset import ASRDataset
from ss_asr_tpu_torch.models import charlm, las
from ss_asr_tpu_torch.utils import checkpoint as ckpt
from test_torch_preprocess import assert_logmel_close

torch.set_num_threads(1)

MDL = {"encoder_state_size": 16, "mlp_out_size": 16, "decoder_state_size": 16,
       "tf_rate": 0.9, "feature_dim": 40}
LM_MDL = {"hidden_size": 8}


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


# --------------------------------------------------------------------------
# pseudolabel


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pseudo")
    mkdata.make_corpus(str(tmp / "corpus"), n=7, seed=3)
    wav_dir = tmp / "corpus" / "wav"
    paths = sorted(str(wav_dir / f) for f in os.listdir(wav_dir))
    (tmp / "other").mkdir()
    shutil.copyfile(paths[0], tmp / "other" / os.path.basename(paths[0]))  # a stem seen twice
    (tmp / "bad.wav").write_bytes(b"not a wav")
    paths += [str(tmp / "other" / os.path.basename(paths[0])), str(tmp / "bad.wav")]
    asr = convert.init_asr_numpy(3, las.ASRConfig(**MDL))
    jckpt.save_pytree(str(tmp / "asr.npz"), asr)
    jckpt.save_pytree(str(tmp / "lm.npz"),
                      convert.init_charlm_numpy(4, charlm.CharLMConfig(**LM_MDL)))
    conf = tmp / "conf.yaml"
    conf.write_text(yaml.safe_dump({"asr": {"mdl": MDL, "decode_beam_size": 1,
                                            "decode_lm_weight": 0.5},
                                    "char_lm": {"mdl": LM_MDL}}))
    return tmp, paths, str(conf)


def _rows(outdir):
    with open(os.path.join(outdir, "index.tsv"), encoding="utf-8") as f:
        return [line.rstrip("\n").split("\t") for line in f]


@pytest.mark.parametrize("decode", [[], ["--beam", "3", "--lm", "LM"]], ids=["greedy", "beam3+lm"])
@pytest.mark.parametrize("floor", ["keep_all", "split"])
def test_pseudolabel_equals_the_jax_cli(wavs, decode, floor):
    tmp, paths, conf = wavs
    tag = f"{floor}_{'beam' if decode else 'greedy'}"
    decode = [str(tmp / "lm.npz") if a == "LM" else a for a in decode]
    common = ["--config", conf, "--sr", "16000", "--max-steps", "16", "--batch", "4", *decode]
    if floor == "keep_all":
        common += ["--min-avg-logprob", "-1000", "--min-chars", "0"]
    else:
        # the median confidence of the keep-all run: about half the rows pass
        _, out = _run(pseudolabel.main, [str(tmp / "asr.npz"), str(tmp / f"probe_{tag}"), *paths,
                                         *common, "--min-avg-logprob", "-1000",
                                         "--min-chars", "0", "--device", "cpu"])
        confs = [float(r[4].split(":")[1]) for r in _rows(tmp / f"probe_{tag}")]
        common += ["--min-avg-logprob", str(float(np.median(confs)))]
    got_dir, want_dir = str(tmp / f"port_{tag}"), str(tmp / f"jax_{tag}")
    rc, got = _run(pseudolabel.main, [str(tmp / "asr.npz"), got_dir, *paths, *common,
                                      "--device", "cpu"])
    jrc, want = _run(jpseudolabel.main, [str(tmp / "asr.npz"), want_dir, *paths, *common])
    assert rc == jrc == 0
    got, want = json.loads(got.strip().splitlines()[-1]), json.loads(want.strip().splitlines()[-1])
    assert got.pop("index") == os.path.join(got_dir, "index.tsv")
    assert want.pop("index") == os.path.join(want_dir, "index.tsv")
    assert got == want
    assert got["n_in"] == 9 and got["rejected_unreadable"] == 1
    if floor == "split":
        assert 0 < got["n_kept"] < 8 and got["rejected_low_conf"] > 0
    else:
        assert got["n_kept"] == 8
    rows, jrows = _rows(got_dir), _rows(want_dir)
    assert len(rows) == len(jrows) == got["n_kept"]
    for r, w in zip(rows, jrows):
        assert r[0] == w[0] and r[2:] == w[2:]  # text, s_len, frames, confidence, wav
        assert os.path.relpath(r[1], got_dir) == os.path.relpath(w[1], want_dir)
        fb, jfb = np.load(r[1]), np.load(w[1])
        assert fb.shape == jfb.shape == (int(r[3]), 40) and fb.dtype == np.float32
        assert_logmel_close(fb, jfb)
    frames = [int(r[3]) for r in rows]
    assert frames == sorted(frames)
    if floor == "keep_all":
        stems = sorted(os.path.basename(r[1]) for r in rows)
        assert "u0000-2.npy" in stems and "u0000.npy" in stems
    ds = ASRDataset(os.path.join(got_dir, "index.tsv"), batch_size=4, t_bucket=8)
    n = sum(int(b.valid.sum()) if b.valid is not None else b.x.shape[0]
            for b in ds.iter_batches(drop_last=False))
    assert n == len(rows)


def test_pseudolabel_refuses_a_missing_gpu(wavs, monkeypatch):
    tmp, paths, conf = wavs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        pseudolabel.main([str(tmp / "asr.npz"), str(tmp / "nogpu"), *paths, "--config", conf])


# --------------------------------------------------------------------------
# checkpoint averaging


def _trees(tmp, rng, n=3):
    paths = []
    for i in range(n):
        tree = {"enc": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                        "b": rng.standard_normal((4,)).astype(np.float32)},
                "step": np.array(10 * (i + 1), np.int32)}
        p = str(tmp / f"c{i}.npz")
        jckpt.save_pytree(p, tree)
        paths.append(p)
    return paths


def test_average_pytrees_equals_the_jax_function(tmp_path, rng):
    paths = _trees(tmp_path, rng)
    got, want = ckpt.average_pytrees(paths), jckpt.average_pytrees(paths)
    flat, jflat = ckpt._flatten(got), jckpt._flatten(want)
    assert sorted(flat) == sorted(jflat) == ["enc/b", "enc/w", "step"]
    for k in flat:
        assert flat[k].dtype == jflat[k].dtype
        np.testing.assert_array_equal(flat[k], jflat[k])
    mean64 = np.mean([np.asarray(jckpt.load_pytree(p)["enc"]["w"], np.float64) for p in paths], 0)
    np.testing.assert_array_equal(flat["enc/w"], mean64.astype(np.float32))
    assert int(flat["step"]) == 20


def test_average_pytrees_raises_the_jax_value_errors(tmp_path, rng):
    paths = _trees(tmp_path, rng, 2)
    jckpt.save_pytree(str(tmp_path / "keys.npz"), {"enc": {"w": np.zeros((3, 4), np.float32)},
                                                   "step": np.array(1, np.int32)})
    jckpt.save_pytree(str(tmp_path / "shape.npz"),
                      {"enc": {"w": np.zeros((3, 5), np.float32), "b": np.zeros(4, np.float32)},
                       "step": np.array(1, np.int32)})
    for bad in ([], [paths[0], str(tmp_path / "keys.npz")],
                [paths[0], str(tmp_path / "shape.npz")]):
        with pytest.raises(ValueError) as got:
            ckpt.average_pytrees(bad)
        with pytest.raises(ValueError) as want:
            jckpt.average_pytrees(bad)
        assert str(got.value) == str(want.value)


def test_cli_avg_ckpt_writes_the_jax_clis_file(tmp_path, rng):
    paths = _trees(tmp_path, rng, 3)
    snap = tmp_path / "snaps"
    snap.mkdir()
    for i, p in enumerate(paths):
        shutil.copyfile(p, ckpt.snapshot_path(str(snap), "asr", 100 * (i + 1)))
    for argv in ([*paths[:2]], ["--ckpdir", str(snap), "--module", "asr", "--last", "2"]):
        _, out = _run(avg_ckpt.main, ["--out", str(tmp_path / "port.npz"), *argv])
        _run(javg_ckpt.main, ["--out", str(tmp_path / "jax.npz"), *argv])
        assert out.startswith("averaged 2 checkpoint(s) -> ")
        got, want = (ckpt._flatten(ckpt.load_pytree(str(tmp_path / f"{n}.npz")))
                     for n in ("port", "jax"))
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    # --last 2 of three snapshots: the two newest
    assert "snap-000000200" in out and "snap-000000300" in out and "snap-000000100" not in out
    for argv in ([], [paths[0], "--ckpdir", str(snap)], ["--ckpdir", str(snap), "--last", "0"],
                 ["--ckpdir", str(snap), "--module", "tae"]):
        for main in (avg_ckpt.main, javg_ckpt.main):
            with pytest.raises(SystemExit) as e, contextlib.redirect_stderr(io.StringIO()):
                main(["--out", str(tmp_path / "x.npz"), *argv])
            assert e.value.code == 2
