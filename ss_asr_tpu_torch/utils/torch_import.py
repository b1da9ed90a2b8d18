"""Import / export of reference (cadia-lvl/ss_asr) PyTorch checkpoints.

Port of ``ss_asr_tpu/utils/torch_import.py``.  The reference saves each
module as ``torch.save(module.state_dict(), path)`` to
``<ckpdir>/<name>/<module_id>.cpt``; this module converts those state dicts
to and from the JAX package's parameter trees, which are this package's
checkpoints too.  The layout rules (``w [in, out]`` against ``weight [out,
in]``, the two LSTM biases merged into ``b``, GRU cells keeping both,
conv kernels HWIO against OIHW) are ``convert``'s, whose modules carry the
reference's state-dict keys: ``import_*`` is ``convert.*_params_from_state``
of the file's tensors and ``export_*`` is ``convert.*_state_from_params``
(the merged LSTM bias written as ``bias_ih`` with a zero ``bias_hh``; the
speech autoencoder's batch norms with ``num_batches_tracked`` 0, as
``nn.BatchNorm2d`` keeps it).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ss_asr_tpu_torch import convert

Flat = Dict[str, np.ndarray]


def _tensors(sd: Flat) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _arrays(sd: Dict[str, torch.Tensor]) -> Flat:
    return {k: v.numpy() for k, v in sd.items()}


def import_asr(sd: Flat) -> Dict:
    """Reference ``ASR.state_dict()`` -> the ``models.las`` tree."""
    return convert.asr_params_from_state(_tensors(sd))


def import_charlm(sd: Flat) -> Dict:
    return convert.charlm_params_from_state(_tensors(sd))


def import_tae(sd: Flat) -> Dict:
    return convert.tae_params_from_state(_tensors(sd))


def import_sae(sd: Flat) -> Tuple[Dict, Dict]:
    """-> (params, bn_state)."""
    return convert.sae_params_from_state(_tensors(sd))


def import_discriminator(sd: Flat) -> Dict:
    return convert.disc_params_from_state(_tensors(sd))


def export_asr(params: Dict) -> Flat:
    return _arrays(convert.asr_state_from_params(params))


def export_charlm(params: Dict) -> Flat:
    return _arrays(convert.charlm_state_from_params(params))


def export_tae(params: Dict) -> Flat:
    return _arrays(convert.tae_state_from_params(params))


def export_sae(params: Dict, bn_state: Dict) -> Flat:
    out = _arrays(convert.sae_state_from_params(params, bn_state))
    for i in range(1, len(params["encoder"]) + 1):
        out[f"encoder.conv_{i}.1.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
    return out


def export_discriminator(params: Dict) -> Flat:
    return _arrays(convert.disc_state_from_params(params))


def detect_module(sd: Flat) -> str:
    """Identify which reference module a state_dict belongs to by its keys."""
    keys = set(sd)
    if any(k.startswith("encoder.blstm_1") for k in keys):
        return "asr"
    if "layer_1.weight_ih" in keys and "emb.weight" in keys:
        return "char_lm"
    if any(k.startswith("encoder.conv_1") for k in keys):
        return "sae"
    if any(k.startswith("encoder.blstm.") for k in keys):
        return "tae"
    if "core.0.weight" in keys:
        return "adv"
    raise ValueError("unrecognized state_dict (keys: %s ...)" % sorted(keys)[:5])


def load_torch_state(path: str) -> Flat:
    """Read a ``torch.save``-d state_dict into numpy arrays."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}


def import_state(sd: Flat, module: Optional[str] = None) -> Tuple[str, Dict]:
    """A reference state_dict -> ``(module_id, tree)``, the tree the trainer
    of that module id saves (the SAE's holds ``{"params", "bn_state"}``;
    ``adv`` is the discriminator)."""
    module = module or detect_module(sd)
    if module == "asr" or module.startswith("asr_"):
        return module, import_asr(sd)
    if module == "char_lm":
        return module, import_charlm(sd)
    if module == "tae":
        return module, import_tae(sd)
    if module == "sae":
        params, bn_state = import_sae(sd)
        return module, {"params": params, "bn_state": bn_state}
    if module in ("adv", "discriminator"):
        return "adv", import_discriminator(sd)
    raise ValueError(f"unknown module id: {module}")


def import_checkpoint(path: str, module: Optional[str] = None) -> Tuple[str, Dict]:
    """Load a reference ``.cpt`` file and convert it (see ``import_state``).

    Without ``module`` the state_dict's keys decide what it is and the
    filename is cross-checked (relay names such as ``asr_1.cpt`` keep their
    stem as the module id); a given ``module`` is trusted as is."""
    sd = load_torch_state(path)
    if module is not None:
        return import_state(sd, "adv" if module == "discriminator" else module)
    detected = detect_module(sd)
    stem = os.path.basename(path).rsplit(".", 1)[0].removesuffix("_best")
    if stem == "asr" or stem.startswith("asr_"):
        if detected != "asr":
            raise ValueError(f"{path} is named like an ASR checkpoint but holds a "
                             f"'{detected}' state_dict")
        return import_state(sd, stem)
    if stem in ("char_lm", "tae", "sae", "adv", "discriminator"):
        base = "adv" if stem == "discriminator" else stem
        if base != detected:
            raise ValueError(f"{path} is named like a '{stem}' checkpoint but holds a "
                             f"'{detected}' state_dict")
    return import_state(sd, detected)
