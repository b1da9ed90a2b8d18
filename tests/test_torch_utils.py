"""The rest of the port's utilities against the JAX package's, on the CPU.

* ``utils.tfevents.read_records`` / ``read_scalars`` read the event files
  that either package's ``EventWriter`` wrote, as the JAX readers do.
* ``utils.profiling.device_trace`` writes a ``torch.profiler`` trace in
  which an ``annotate`` region appears; disabled, it writes nothing.
* ``decode.greedy.greedy_decode`` and ``fused_decode_from_memory`` return
  the tokens and lengths of the JAX functions of those names, with and
  without the char-LM (weight 0 means no LM, as there).
* ``pyproject.toml`` names the port's CLIs as console scripts and a
  ``torch`` extra, beside the JAX entries.
"""

import glob
import json
import tomllib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss_asr_tpu.decode import greedy as jgreedy
from ss_asr_tpu.models import las as jlas
from ss_asr_tpu.utils import tfevents as jtfevents
from ss_asr_tpu_torch.decode import greedy
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.utils import profiling, tfevents
from test_torch_decode import SIZES, _inputs, _models

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("writer", [tfevents, jtfevents], ids=["port", "jax"])
def test_readers_read_either_packages_event_files(tmp_path, writer):
    w = writer.EventWriter(str(tmp_path))
    w.scalar("loss", 3.5, 1)
    w.scalar("loss", 2.25, 2)
    w.scalar("acc", 0.75, 2)
    w.close()
    (path,) = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    got, want = tfevents.read_scalars(path), jtfevents.read_scalars(path)
    assert got == want == [("loss", 3.5, 1), ("loss", 2.25, 2), ("acc", 0.75, 2)]
    assert list(tfevents.read_records(path)) == list(jtfevents.read_records(path))


def test_read_records_checks_the_crcs(tmp_path):
    w = tfevents.EventWriter(str(tmp_path))
    w.scalar("loss", 1.0, 1)
    w.close()
    (path,) = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    data = bytearray(Path(path).read_bytes())
    data[-5] ^= 0xFF  # a byte of the last record's payload
    Path(path).write_bytes(bytes(data))
    with pytest.raises(AssertionError, match="data CRC mismatch"):
        list(tfevents.read_records(path))
    assert len(list(tfevents.read_records(path, verify=False))) == 2


def test_device_trace_holds_the_annotated_region(tmp_path):
    with profiling.device_trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "off").exists()
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("smoke_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert "smoke_region" in [e.name for e in prof.events()]
    (path,) = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    events = json.loads(Path(path).read_text())["traceEvents"]
    assert any(e.get("name") == "smoke_region" for e in events)


@pytest.mark.parametrize("lm_weight", [0.0, 0.5])
def test_greedy_entry_points_match_jax(rng, lm_weight):
    jp, model, lcfg, jlm, lm = _models(5)
    cfg = jlas.ASRConfig(**SIZES)
    x, xl = _inputs(rng, [24, 9, 17])
    kw = dict(lm_params=jlm, lm_cfg=lcfg, lm_weight=lm_weight)
    want = jgreedy.greedy_decode(jp, cfg, jnp.asarray(x), jnp.asarray(xl), 15, **kw)
    enc_h, enc_lens = jlas.listener_apply(jp["encoder"], jnp.asarray(x), jnp.asarray(xl))
    want_m = jgreedy.fused_decode_from_memory(jp, cfg, enc_h, enc_lens, 15, **kw)
    with torch.inference_mode():
        got = greedy.greedy_decode(model, torch.from_numpy(x), torch.from_numpy(xl), 15, lm,
                                   lm_weight)
        h, hl = las.listener_apply(model.encoder, torch.from_numpy(x), torch.from_numpy(xl))
        got_m = greedy.fused_decode_from_memory(model, h, hl, 15, lm, lm_weight)
    for g, w in ((got, want), (got_m, want_m)):
        for a, b in zip(g, w):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (np.asarray(want[1]) > 0).any()
    if lm_weight:  # the LM moves the tokens
        plain = jgreedy.greedy_decode(jp, cfg, jnp.asarray(x), jnp.asarray(xl), 15)
        assert not np.array_equal(np.asarray(plain[0]), np.asarray(want[0]))


def test_pyproject_names_the_ports_clis_and_extra():
    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]
    scripts = meta["scripts"]
    for name in ("train", "serve", "transcribe", "preprocess", "mkdata", "generate",
                 "lm-predict", "pseudolabel", "avg-ckpt", "import-ckpt"):
        module, _, func = scripts[f"ss-asr-torch-{name}"].partition(":")
        assert module == f"ss_asr_tpu_torch.cli.{name.replace('-', '_')}" and func == "main"
        assert (ROOT / (module.replace(".", "/") + ".py")).exists()
    assert any(r.startswith("torch") for r in meta["optional-dependencies"]["torch"])
    assert all(not v.startswith("ss_asr_tpu_torch") for k, v in scripts.items()
               if not k.startswith("ss-asr-torch-"))


def test_install_check_runs_every_torch_script(monkeypatch, capsys):
    """``install_check`` covers every ``ss-asr-torch-*`` script of the TOML,
    and says so, without installing, when setuptools is missing."""
    import importlib.util

    from ss_asr_tpu_torch import install_check

    names = install_check.torch_scripts(str(ROOT / "pyproject.toml"))
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    assert names == sorted(k for k in scripts if k.startswith("ss-asr-torch-")) and len(names) == 10
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "setuptools" else real(name, *a))
    assert install_check.main([]) == 2
    assert "setuptools is missing" in capsys.readouterr().out
