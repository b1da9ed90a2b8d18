"""The port's ``import_ckpt`` against the JAX package's, on the CPU.

Reference-keyed state dicts are built in place by the torch replicas of
``tests/test_torch_import.py`` (every module family: the ASR under its own,
its best and a relay name, the char-LM, the TAE, the SAE with batch-norm
statistics, the discriminator under ``adv`` and ``discriminator``).  Both
CLIs convert the same directory: the npz files hold equal arrays under equal
keys and ``tracker.json`` is copied; ``--export`` of those files gives
``.cpt`` files of equal tensors.  Also the errors: ``detect_module``'s, the
filename cross-check, ``--module`` on a directory, a ``SKIP`` line.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ss_asr_tpu.cli import import_ckpt as jcli
from ss_asr_tpu.utils import checkpoint as jckpt
from ss_asr_tpu.utils import torch_import as jti
from ss_asr_tpu_torch.cli import import_ckpt as cli
from ss_asr_tpu_torch.utils import checkpoint as ckpt
from ss_asr_tpu_torch.utils import torch_import as ti
from test_torch_import import _RefASR, _RefCharLM, _RefDiscriminator, _RefSAE, _RefTAE

ROOT = Path(__file__).resolve().parents[1]


def _ref_sae():
    m = _RefSAE([[1, 8], [5, 1], [3, 1]], [8, 12, 16], [[3, 1], [5, 1], [4, 9]], 36, 32)
    g = torch.Generator().manual_seed(3)
    for name, buf in m.named_buffers():  # statistics off their initial values
        if name.endswith("running_mean"):
            buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
        elif name.endswith("running_var"):
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
        elif name.endswith("num_batches_tracked"):
            buf.fill_(17)
    return m


def _state_dicts():
    torch.manual_seed(11)
    asr = _RefASR()
    with torch.no_grad():  # the reference's second LSTM bias is not zero
        for n, p in asr.named_parameters():
            if "bias_hh" in n:
                p.copy_(torch.randn_like(p))
    return {"asr.cpt": asr.state_dict(), "asr_best.cpt": _RefASR().state_dict(),
            "asr_1.cpt": _RefASR().state_dict(), "char_lm.cpt": _RefCharLM().state_dict(),
            "tae.cpt": _RefTAE().state_dict(), "sae.cpt": _ref_sae().state_dict(),
            "adv.cpt": _RefDiscriminator().state_dict(),
            "discriminator_best.cpt": _RefDiscriminator().state_dict()}


@pytest.fixture
def ref_dir(tmp_path):
    src = tmp_path / "ref_run"
    src.mkdir()
    for name, sd in _state_dicts().items():
        torch.save(sd, src / name)
    (src / "tracker.json").write_text('{"asr": {"best": 1.25, "step": 7}}')
    return src


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_npz_equal(a, b):
    fa, fb = _flat(ckpt.load_pytree(str(a))), _flat(jckpt.load_pytree(str(b)))
    assert sorted(fa) == sorted(fb), a
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{a.name} {k}")


def _assert_cpt_equal(a, b):
    sa = torch.load(a, map_location="cpu", weights_only=True)
    sb = torch.load(b, map_location="cpu", weights_only=True)
    assert sorted(sa) == sorted(sb), a
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), (a, k)


def test_directory_import_and_export_equal_the_jax_cli(ref_dir, tmp_path):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    assert cli.main([str(ref_dir), str(ours)]) == 0
    assert jcli.main([str(ref_dir), str(theirs)]) == 0
    names = sorted(p.name for p in theirs.iterdir())
    assert sorted(p.name for p in ours.iterdir()) == names
    assert {"asr.npz", "asr_1.npz", "sae.npz", "discriminator_best.npz", "tracker.json"} <= set(names)
    for n in names:
        if n.endswith(".npz"):
            _assert_npz_equal(ours / n, theirs / n)
    assert json.loads((ours / "tracker.json").read_text()) == {"asr": {"best": 1.25, "step": 7}}
    # the merged bias of the reference's two
    sd = _state_dicts()["asr.cpt"]
    b = ckpt.load_pytree(str(ours / "asr.npz"))["decoder"]["layer1"]["b"]
    np.testing.assert_array_equal(b, (sd["decoder.layer_1.bias_ih"]
                                      + sd["decoder.layer_1.bias_hh"]).numpy())
    # --export of the same npz files (an optimizer state beside them is skipped)
    ckpt.save_opt_state(str(theirs / "asr_opt.npz"), [np.zeros(3, np.float32)])
    back_ours, back_theirs = tmp_path / "back_ours", tmp_path / "back_theirs"
    assert cli.main([str(theirs), str(back_ours), "--export"]) == 0
    assert jcli.main([str(theirs), str(back_theirs), "--export"]) == 0
    cpts = sorted(p.name for p in back_theirs.iterdir())
    assert sorted(p.name for p in back_ours.iterdir()) == cpts
    assert "asr_opt.cpt" not in cpts and "sae.cpt" in cpts and "tracker.json" not in cpts
    for n in cpts:
        _assert_cpt_equal(back_ours / n, back_theirs / n)


def test_export_then_import_round_trips(ref_dir, tmp_path):
    """Reference file -> npz -> reference keys: every tensor back, the
    merged LSTM bias as bias_ih with a zero bias_hh (their sum unchanged)."""
    assert cli.main([str(ref_dir), str(tmp_path / "npz")]) == 0
    assert cli.main([str(tmp_path / "npz"), str(tmp_path / "cpt"), "--export"]) == 0
    for name, sd in _state_dicts().items():
        got = torch.load(tmp_path / "cpt" / name, map_location="cpu", weights_only=True)
        for k, v in sd.items():
            if k.endswith("num_batches_tracked"):
                assert int(got[k]) == 0
            elif "bias_ih" in k:
                hh = k.replace("bias_ih", "bias_hh")
                assert torch.equal(got[k] + got[hh], v + sd[hh]), (name, k)
            elif "bias_hh" not in k or name.startswith("char_lm"):
                assert torch.equal(got[k], v), (name, k)


def test_detect_module_and_its_error():
    sds = _state_dicts()
    for name, want in (("asr.cpt", "asr"), ("char_lm.cpt", "char_lm"), ("tae.cpt", "tae"),
                       ("sae.cpt", "sae"), ("adv.cpt", "adv")):
        flat = {k: v.numpy() for k, v in sds[name].items()}
        assert ti.detect_module(flat) == jti.detect_module(flat) == want
    odd = {"something.weight": np.zeros(2)}
    for mod in (ti, jti):
        with pytest.raises(ValueError, match="unrecognized state_dict"):
            mod.detect_module(odd)


def test_filename_cross_check_and_forced_module(tmp_path):
    lm = _RefCharLM().state_dict()
    for bad in ("sae.cpt", "asr_2.cpt"):
        torch.save(lm, tmp_path / bad)
        for mod in (ti, jti):
            with pytest.raises(ValueError, match="is named like"):
                mod.import_checkpoint(str(tmp_path / bad))
    torch.save(_RefASR().state_dict(), tmp_path / "asr_3.cpt")
    assert ti.import_checkpoint(str(tmp_path / "asr_3.cpt"))[0] == "asr_3"
    # a forced module id names the output (the alias discriminator -> adv)
    torch.save(_RefDiscriminator().state_dict(), tmp_path / "whatever.cpt")
    assert cli.main([str(tmp_path / "whatever.cpt"), str(tmp_path / "out"),
                     "--module", "discriminator"]) == 0
    assert jcli.main([str(tmp_path / "whatever.cpt"), str(tmp_path / "jout"),
                      "--module", "discriminator"]) == 0
    _assert_npz_equal(tmp_path / "out" / "adv.npz", tmp_path / "jout" / "adv.npz")


def test_cli_errors_exit_1(ref_dir, tmp_path, capsys):
    dest = tmp_path / "out"
    assert cli.main([str(tmp_path / "nope"), str(dest)]) == 1
    assert cli.main([str(ref_dir), str(dest), "--module", "asr"]) == 1
    assert "--module only applies to a single file" in capsys.readouterr().err
    torch.save(_RefCharLM().state_dict(), ref_dir / "tae_best.cpt")  # char-LM weights
    assert cli.main([str(ref_dir), str(dest)]) == 1
    err = capsys.readouterr().err
    assert err.startswith("SKIP ") and "tae_best.cpt" in err and err.count("SKIP") == 1
    assert (dest / "asr.npz").exists() and (dest / "tracker.json").exists()
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main([str(empty), str(dest), "--export"]) == 1


def test_the_module_runs_as_a_script(ref_dir, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    for args in ([str(ref_dir / "char_lm.cpt"), str(tmp_path / "a")],
                 [str(tmp_path / "a" / "char_lm.npz"), str(tmp_path / "b"), "--export"]):
        proc = subprocess.run([sys.executable, "-m", "ss_asr_tpu_torch.cli.import_ckpt", *args],
                              cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert " -> " in proc.stdout
    _assert_cpt_equal(tmp_path / "b" / "char_lm.cpt", ref_dir / "char_lm.cpt")
