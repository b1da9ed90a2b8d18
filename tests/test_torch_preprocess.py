"""The port's data preparation against the JAX package's.

* ``cli.mkdata`` is a copy: the same seed writes byte-identical wav and txt
  files (plain and ``--hard``).
* ``cli.preprocess generic --device cpu`` writes the same ``index.tsv``
  (rows, order, text, lengths, frame counts; only the directory differs) and
  fbanks within 5e-4 in the log-mel domain for every energy within 60 dB of
  its frame's peak.  That is 5x the white-noise tolerance of
  ``tests/test_torch_frontend.py``: the corpus is pure tones, whose energy
  sits in a few bins, so a band 50-60 dB under the peak is a difference of
  large float32 products and carries their rounding (measured 1.4e-4).
  ``--pad-to-max`` pads every file to the longest.
* ``malromur`` reads the verified rows of a hand-made csv index.
* ``data.xmlparser`` flattens a TEI document as the JAX package's does.
"""

import csv
import filecmp
import os

import numpy as np
import pytest
import torch

from ss_asr_tpu.cli import mkdata as jmkdata
from ss_asr_tpu.cli import preprocess as jpre
from ss_asr_tpu.data import xmlparser as jxml
from ss_asr_tpu_torch.cli import mkdata, preprocess
from ss_asr_tpu_torch.data import xmlparser
from test_torch_frontend import FLOOR_DB

TONE_ATOL = 5e-4

torch.set_num_threads(1)


def assert_logmel_close(got, want):
    assert got.shape == want.shape
    floor = want.max(axis=-1, keepdims=True) - FLOOR_DB * np.log(10) / 10
    above = want > floor
    np.testing.assert_allclose(got[above], want[above], atol=TONE_ATOL, rtol=0)
    assert np.all(got[~above] < floor.repeat(got.shape[-1], -1)[~above] + 1.0)


def _rows(path):
    with open(path, encoding="utf-8") as f:
        return list(csv.reader(f, delimiter="\t", quoting=csv.QUOTE_NONE))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mkdata")
    mkdata.main([str(tmp / "port"), "--n", "70", "--seed", "3"])
    jmkdata.main([str(tmp / "jax"), "--n", "70", "--seed", "3"])
    return tmp


def test_mkdata_writes_the_same_bytes(corpus, tmp_path):
    for sub in ("wav", "txt"):
        names = sorted(os.listdir(corpus / "jax" / sub))
        assert len(names) == 70 and names == sorted(os.listdir(corpus / "port" / sub))
        match, mismatch, errors = filecmp.cmpfiles(corpus / "jax" / sub, corpus / "port" / sub,
                                                   names, shallow=False)
        assert (len(match), mismatch, errors) == (70, [], [])
    mkdata.main([str(tmp_path / "port"), "--n", "4", "--seed", "1", "--hard"])
    jmkdata.main([str(tmp_path / "jax"), "--n", "4", "--seed", "1", "--hard"])
    names = sorted(os.listdir(tmp_path / "jax" / "wav"))
    assert filecmp.cmpfiles(tmp_path / "jax" / "wav", tmp_path / "port" / "wav", names,
                            shallow=False)[0] == names


def test_preprocess_generic_writes_the_jax_index_and_fbanks(corpus):
    """70 utterances: one full group of 64 and a padded partial one."""
    src = corpus / "port"
    preprocess.main(["generic", str(corpus / "out_port"), str(src / "wav"), str(src / "txt"),
                     "--sr", "8000", "--device", "cpu"])
    jpre.main(["generic", str(corpus / "out_jax"), str(src / "wav"), str(src / "txt"),
               "--sr", "8000"])
    got, want = _rows(corpus / "out_port" / "index.tsv"), _rows(corpus / "out_jax" / "index.tsv")
    assert len(got) == len(want) == 70
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[2:] == w[2:]
        assert os.path.basename(g[1]) == os.path.basename(w[1])
        a, b = np.load(g[1]), np.load(w[1])
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (int(g[3]), 40)
        assert_logmel_close(a, b)
    assert [int(r[3]) for r in got] == sorted(int(r[3]) for r in got)


def test_pad_to_max_restores_the_reference_layout(corpus, tmp_path):
    src = corpus / "port"
    # a subset: link the first 5 pairs into a corpus of their own
    for sub in ("wav", "txt"):
        (tmp_path / sub).mkdir()
        for name in sorted(os.listdir(src / sub))[:5]:
            os.symlink(src / sub / name, tmp_path / sub / name)
    preprocess.main(["generic", str(tmp_path / "out"), str(tmp_path / "wav"), str(tmp_path / "txt"),
                     "--sr", "8000", "--pad-to-max", "--device", "cpu"])
    rows = _rows(tmp_path / "out" / "index.tsv")
    longest = max(int(r[3]) for r in rows)
    for r in rows:
        fb = np.load(r[1])
        assert fb.shape == (longest, 40) and np.all(fb[int(r[3]):] == 0.0)


def test_preprocess_malromur_reads_the_verified_rows(corpus, tmp_path):
    src = corpus / "port"
    names = sorted(os.listdir(src / "wav"))[:4]
    with open(tmp_path / "index.csv", "w", encoding="utf-8") as f:
        for i, name in enumerate(names):
            stem = name[: -len(".wav")]
            verdict = "correct" if i != 2 else "incorrect"
            f.write(f"{stem},a,b,c,d,Halló  Heimur {i},e,{verdict},f\n")
        f.write("short,row\n")
    for mod, out, extra in ((preprocess, "port", ["--device", "cpu"]), (jpre, "jax", [])):
        mod.main(["malromur", str(tmp_path / out), str(tmp_path / "index.csv"), str(src / "wav"),
                  "--sr", "8000"] + extra)
    got, want = _rows(tmp_path / "port" / "index.tsv"), _rows(tmp_path / "jax" / "index.tsv")
    assert len(got) == len(want) == 3
    assert sorted(r[0] for r in got) == ["<halló heimur 0>", "<halló heimur 1>",
                                         "<halló heimur 3>"]
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[2:] == w[2:]
        assert_logmel_close(np.load(g[1]), np.load(w[1]))


def test_preprocess_refuses_missing_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        preprocess.main(["generic", str(tmp_path / "o"), str(tmp_path), str(tmp_path)])


def test_xmlparser_matches_the_jax_package(tmp_path):
    ns = 'xmlns="http://www.tei-c.org/ns/1.0"'
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "a.xml").write_text(
        f'<TEI {ns}><text><s><w>Halló</w><c>,</c><w>heimur</w><w/><c>!</c></s>'
        f'<s><w>Já</w></s></text></TEI>', encoding="utf-8")
    assert (xmlparser.parse_document(str(tmp_path / "d" / "a.xml"))
            == jxml.parse_document(str(tmp_path / "d" / "a.xml")) == "Halló, heimur! Já")
    for mod, out in ((xmlparser, "p"), (jxml, "j")):
        assert mod.parse(str(tmp_path / "d"), str(tmp_path / f"{out}.txt"), reset_file=True) == 1
        mod.prepro_file(str(tmp_path / f"{out}.txt"), str(tmp_path / f"{out}.norm"))
    assert (tmp_path / "p.norm").read_text() == (tmp_path / "j.norm").read_text() \
        == "halló, heimur$ já\n"
