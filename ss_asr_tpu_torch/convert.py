"""Weights across the two packages.

* ``asr_state_from_params`` / ``charlm_state_from_params``: a JAX parameter
  tree (numpy leaves — e.g. ``utils.checkpoint.load_pytree`` of a JAX
  checkpoint) -> this package's ``state_dict``.  The layout rules are those
  of ``export_asr`` / ``export_charlm`` in
  ``ss_asr_tpu/utils/torch_import.py``: ``w [in, out]`` is transposed to
  ``weight [out, in]``; the merged LSTM bias ``b`` becomes ``bias_ih`` plus
  a zero ``bias_hh``; GRU cells keep both biases.
* ``init_asr_numpy`` / ``init_charlm_numpy``: seeded numpy draws with the
  shapes and distributions of the JAX initializers (``ops/rnn.py``
  ``lecun_normal`` / ``init_lstm`` / ``init_gru`` / ``init_embedding``,
  ``models/las.py`` ``init_asr``, ``models/charlm.py`` ``init_charlm``):
  lecun-normal matrices, zero biases, a speller forget bias of 1.0, N(0, 1)
  embeddings, uniform(±1/sqrt(H)) GRUs.  They return the JAX tree layout,
  so ``save_pytree`` writes a checkpoint both packages load.  The numbers
  differ from ``jax.random``'s for the same seed; only the distributions
  match.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ss_asr_tpu_torch.models.charlm import CharLMConfig
from ss_asr_tpu_torch.models.las import ASRConfig

Tree = Dict


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32).T))


def _f(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear_to(p: Tree, prefix: str, out: Dict) -> None:
    out[prefix + ".weight"] = _t(p["w"])
    if "b" in p:
        out[prefix + ".bias"] = _f(p["b"])


def _lstm_to(p: Tree, prefix: str, suffix: str, out: Dict) -> None:
    out[f"{prefix}.weight_ih{suffix}"] = _t(p["w_ih"])
    out[f"{prefix}.weight_hh{suffix}"] = _t(p["w_hh"])
    out[f"{prefix}.bias_ih{suffix}"] = _f(p["b"])
    out[f"{prefix}.bias_hh{suffix}"] = torch.zeros_like(_f(p["b"]))


def _bilstm_to(p: Tree, prefix: str, out: Dict) -> None:
    _lstm_to(p["fwd"], prefix, "_l0", out)
    _lstm_to(p["bwd"], prefix, "_l0_reverse", out)


def _gru_to(p: Tree, prefix: str, out: Dict) -> None:
    out[prefix + ".weight_ih"] = _t(p["w_ih"])
    out[prefix + ".weight_hh"] = _t(p["w_hh"])
    out[prefix + ".bias_ih"] = _f(p["b_ih"])
    out[prefix + ".bias_hh"] = _f(p["b_hh"])


def asr_state_from_params(tree: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``models.las`` tree -> ``LAS.state_dict()``."""
    out: Dict[str, torch.Tensor] = {}
    enc = tree["encoder"]
    for i in (1, 2, 3):
        _bilstm_to(enc[f"pblstm{i}"], f"encoder.blstm_{i}.layer", out)
    _bilstm_to(enc["blstm4"], "encoder.blstm_4", out)
    _linear_to(tree["attention"]["phi"], "attention.phi", out)
    _linear_to(tree["attention"]["psi"], "attention.psi", out)
    _lstm_to(tree["decoder"]["layer1"], "decoder.layer_1", "", out)
    _lstm_to(tree["decoder"]["layer2"], "decoder.layer_2", "", out)
    out["embed.weight"] = _f(tree["embed"]["table"])
    _linear_to(tree["char_trans"], "char_trans", out)
    return out


def charlm_state_from_params(tree: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``models.charlm`` tree -> ``CharLM.state_dict()``."""
    out: Dict[str, torch.Tensor] = {"emb.weight": _f(tree["emb"]["table"])}
    _gru_to(tree["gru1"], "layer_1", out)
    _gru_to(tree["gru2"], "layer_2", out)
    _linear_to(tree["out"], "out", out)
    return out


# ---------------------------------------------------------------------------
# Seeded init in the JAX tree layout
# ---------------------------------------------------------------------------

def _lecun(rng: np.random.Generator, shape) -> np.ndarray:
    return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)


def _lstm(rng, in_dim: int, hidden: int, forget_bias: float = 0.0) -> Tree:
    b = np.zeros((4 * hidden,), np.float32)
    b[hidden : 2 * hidden] = forget_bias
    return {"w_ih": _lecun(rng, (in_dim, 4 * hidden)),
            "w_hh": _lecun(rng, (hidden, 4 * hidden)), "b": b}


def _gru(rng, in_dim: int, hidden: int) -> Tree:
    bound = 1.0 / np.sqrt(hidden)

    def u(shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    return {"w_ih": u((in_dim, 3 * hidden)), "w_hh": u((hidden, 3 * hidden)),
            "b_ih": u((3 * hidden,)), "b_hh": u((3 * hidden,))}


def _linear(rng, in_dim: int, out_dim: int, bias: bool = True) -> Tree:
    p = {"w": _lecun(rng, (in_dim, out_dim))}
    if bias:
        p["b"] = np.zeros((out_dim,), np.float32)
    return p


def init_asr_numpy(seed: int, cfg: ASRConfig) -> Tree:
    rng = np.random.default_rng(seed)
    s, d = cfg.encoder_state_size, cfg.decoder_state_size

    def bi(in_dim):
        return {"fwd": _lstm(rng, in_dim, s), "bwd": _lstm(rng, in_dim, s)}

    return {
        "encoder": {"pblstm1": bi(cfg.feature_dim), "pblstm2": bi(4 * s),
                    "pblstm3": bi(4 * s), "blstm4": bi(4 * s)},
        "attention": {"phi": _linear(rng, d, cfg.mlp_out_size, bias=False),
                      "psi": _linear(rng, cfg.enc_out_dim, cfg.mlp_out_size)},
        "decoder": {"layer1": _lstm(rng, cfg.enc_out_dim + d, d, forget_bias=1.0),
                    "layer2": _lstm(rng, d, d, forget_bias=1.0)},
        "embed": {"table": rng.standard_normal((cfg.vocab_size, d)).astype(np.float32)},
        "char_trans": _linear(rng, d, cfg.vocab_size),
    }


def init_charlm_numpy(seed: int, cfg: CharLMConfig) -> Tree:
    rng = np.random.default_rng(seed)
    h = cfg.hidden_size
    return {
        "emb": {"table": rng.standard_normal((cfg.vocab_size, h)).astype(np.float32)},
        "gru1": _gru(rng, h, h),
        "gru2": _gru(rng, h, h),
        "out": _linear(rng, h, cfg.vocab_size),
    }
