"""The port's index tools and ``ASRDataset`` against the JAX package's: the
files that ``save_index``, ``make_split``, ``sort_index`` and
``subset_by_t`` write, byte for byte, and the batches of a sorted or
shuffled dataset, field for field, on the same index and seed."""

import numpy as np
import pytest

from ss_asr_tpu.data import asr_dataset as jds
from ss_asr_tpu.data import index as jindex
from ss_asr_tpu_torch.data import asr_dataset as tds
from ss_asr_tpu_torch.data import index as tindex
from conftest import write_asr_corpus

# texts of repeated lengths, so that sorting by s_len meets ties
TEXTS = ["halló", "já", "nei", "takk", "bless", "jæja", "hæ", "góðan dag", "hvað",
         "ég", "þú", "gott", "vel", "ok", "sæl", "bæ", "jú", "úti", "inni", "heim",
         "dagur", "nótt", "sól", "máni"]


def _write(path, rows):
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write("\t".join(str(a) for a in r) + "\n")


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    """An index of 40 rows with ties in every sort key, an empty wav name and
    a quote inside one field (both packages must quote it alike)."""
    tmp = tmp_path_factory.mktemp("index")
    rng = np.random.default_rng(4)
    rows = []
    for i in range(40):
        text = TEXTS[int(rng.integers(len(TEXTS)))]
        wav = "" if i == 7 else ('say "hi".wav' if i == 9 else f"u{int(rng.integers(6))}.wav")
        rows.append((text, f"/data/f{i}.npy", int(rng.integers(3, 7)), int(rng.integers(20, 26)),
                     "na", wav))
    path = tmp / "index.tsv"
    _write(path, rows)
    return path


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_save_index_writes_the_bytes_of_the_jax_package(index, tmp_path):
    jindex.save_index(jindex.load_index(str(index)), str(tmp_path / "j.tsv"))
    tindex.save_index(tindex.load_index(str(index)), str(tmp_path / "t.tsv"))
    assert _read(tmp_path / "t.tsv") == _read(tmp_path / "j.tsv")
    assert b'"say ""hi"".wav"' in _read(tmp_path / "t.tsv")


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("train_r", [0.9, 0.5])
def test_make_split_equals_the_jax_split(index, tmp_path, seed, train_r):
    out = {}
    for name, mod in (("j", jindex), ("t", tindex)):
        d = tmp_path / name
        d.mkdir()
        src = d / "index.tsv"
        src.write_bytes(_read(index))
        mod.make_split(str(src), train_r, 1.0 - train_r, seed=seed)
        out[name] = (_read(d / "train.tsv"), _read(d / "eval.tsv"))
    assert out["t"] == out["j"]
    assert out["t"][0] and out["t"][1]  # both sides hold rows


@pytest.mark.parametrize("key", ["s_len", "unpadded_num_frames", "normalized_text", "wav_fname"])
@pytest.mark.parametrize("ascending", [True, False])
def test_sort_index_equals_the_jax_sort(index, tmp_path, key, ascending):
    jindex.sort_index(str(index), key, ascending, out_index=str(tmp_path / "j.tsv"))
    tindex.sort_index(str(index), key, ascending, out_index=str(tmp_path / "t.tsv"))
    assert _read(tmp_path / "t.tsv") == _read(tmp_path / "j.tsv")
    rows = tindex.load_index(str(tmp_path / "t.tsv"))
    vals = [r[key] for r in rows if r[key] != ""]
    assert vals == sorted(vals, reverse=not ascending)


@pytest.mark.parametrize("seed", [0, 11])
def test_subset_by_t_draws_the_rows_of_dataframe_sample(index, tmp_path, seed):
    jindex.subset_by_t(90.0, str(index), str(tmp_path / "j.tsv"), seed=seed)
    tindex.subset_by_t(90.0, str(index), str(tmp_path / "t.tsv"), seed=seed)
    got = _read(tmp_path / "t.tsv")
    assert got == _read(tmp_path / "j.tsv")
    assert got.count(b"\n") == 20


def test_subset_by_t_refuses_the_whole_corpus(index, tmp_path):
    with pytest.raises(ValueError, match="holds only 40"):
        tindex.subset_by_t(40 * 4.5, str(index), str(tmp_path / "t.tsv"), seed=0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A fbank corpus (rows of 24-47 frames) whose rows are NOT in length
    order, so that a sort by either count moves them; s_len ties."""
    tmp = tmp_path_factory.mktemp("corpus")
    idx = write_asr_corpus(tmp, TEXTS, feature_dim=4)
    rows = tindex.load_index(idx)
    order = np.random.default_rng(2).permutation(len(rows))
    tindex.save_index([rows[i] for i in order], idx)
    return idx


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for field in ("x", "x_lens", "y", "y_lens", "y_noised", "y_noised_lens", "valid"):
            a, b = getattr(g, field), getattr(w, field)
            assert (a is None) == (b is None), field
            if a is not None:
                assert a.dtype == b.dtype, field
                np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("key", ["s_len", "unpadded_num_frames", "normalized_text"])
@pytest.mark.parametrize("ascending", [True, False])
def test_sorted_dataset_batches_equal_the_jax_package(corpus, key, ascending):
    kw = dict(batch_size=5, t_bucket=8, l_bucket=8, sort_key=key, sort_ascending=ascending)
    want = list(jds.ASRDataset(corpus, **kw).iter_batches(drop_last=False))
    got = list(tds.ASRDataset(corpus, **kw).iter_batches(drop_last=False))
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("seed", [3, None])
def test_shuffled_dataset_batches_equal_the_jax_package(corpus, seed):
    """The same start order for a seed; without one, the order comes from the
    dataset's own generator, which the char-drop noise then continues."""
    kw = dict(batch_size=4, text_only=True, drop_rate=0.3, l_bucket=8, seed=9)
    jd, td = jds.ASRDataset(corpus, **kw), tds.ASRDataset(corpus, **kw)
    for _ in range(2):  # a second epoch draws another order
        want = list(jd.iter_batches(shuffle=True, seed=seed, prefetch=0))
        got = list(td.iter_batches(shuffle=True, seed=seed))
        _assert_batches_equal(got, want)
    plain = list(tds.ASRDataset(corpus, **kw).iter_batches())
    assert any(not np.array_equal(a.y, b.y) for a, b in zip(got, plain))


def test_reference_helpers_equal_the_jax_package(corpus, rng):
    jm, jd = jds.load_asr_dataset(corpus, 4, t_bucket=8)
    tm, td = tds.load_asr_dataset(corpus, 4, t_bucket=8)
    assert (td.get_char_dim(), td.get_feature_dim()) == (jd.get_char_dim(), jd.get_feature_dim())
    assert tm.get_dim() == jm.get_dim() and td.get_feature_dim() == 4
    x = rng.standard_normal((3, 10, 4)).astype(np.float32)
    x[1, 6:] = 0.0
    y = rng.integers(1, 20, (3, 9)).astype(np.int32)
    y[2, 5:] = 0
    for got, want in ((tds.prepare_x(x), jds.prepare_x(x)), (tds.prepare_x(x[None]), jds.prepare_x(x)),
                      (tds.prepare_y(y), jds.prepare_y(y)), (tds.prepare_y(y[None]), jds.prepare_y(y))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
