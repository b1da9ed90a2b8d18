"""Weights across the two packages.

* ``asr_state_from_params`` / ``charlm_state_from_params``: a JAX parameter
  tree (numpy leaves — e.g. ``utils.checkpoint.load_pytree`` of a JAX
  checkpoint) -> this package's ``state_dict``.  The layout rules are those
  of ``export_asr`` / ``export_charlm`` in
  ``ss_asr_tpu/utils/torch_import.py``: ``w [in, out]`` is transposed to
  ``weight [out, in]``; the merged LSTM bias ``b`` becomes ``bias_ih`` plus
  a zero ``bias_hh``; GRU cells keep both biases.  ``asr_params_from_state``
  is the inverse (the trainer's checkpoints).
* ``tae_*``, ``sae_*`` (with the batch-norm state, and the conv kernels
  HWIO <-> OIHW) and ``disc_*``: the same pairs for the text autoencoder,
  the speech autoencoder and the discriminator; their ``state_dict`` keys are
  those of ``export_tae`` / ``export_sae`` / ``export_discriminator`` there.
* ``asr_leaf_layout``: the JAX leaf's shape behind each ``LAS`` tensor,
  on which tensor parallelism shards (``parallel/mesh.py``).
* ``opt_state_leaves`` / ``load_opt_state_leaves``: an optimizer over several
  models' parameters (named ``<model>.<state_dict key>``), masked to some
  subtrees, as the leaves of the JAX package's optax state (the char-LM
  trainer's: ``{"char_lm": lm}``, unmasked); ``asr_opt_state_leaves`` and
  its loader for the ASR trainer, whose parameters carry their
  ``state_dict`` names.
* ``init_asr_numpy`` / ``init_charlm_numpy`` / ``init_tae_numpy`` /
  ``init_sae_numpy`` / ``init_disc_numpy``: seeded numpy draws with the
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

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ss_asr_tpu_torch.models.charlm import CharLMConfig
from ss_asr_tpu_torch.models.discriminator import DiscriminatorConfig
from ss_asr_tpu_torch.models.las import ASRConfig
from ss_asr_tpu_torch.models.speech_autoencoder import SAEConfig
from ss_asr_tpu_torch.models.text_autoencoder import TAEConfig

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


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _lstm_from(sd, prefix: str, suffix: str) -> Tree:
    return {"w_ih": _n(sd[f"{prefix}.weight_ih{suffix}"]).T,
            "w_hh": _n(sd[f"{prefix}.weight_hh{suffix}"]).T,
            "b": _n(sd[f"{prefix}.bias_ih{suffix}"] + sd[f"{prefix}.bias_hh{suffix}"])}


def _linear_from(sd, prefix: str) -> Tree:
    p = {"w": _n(sd[prefix + ".weight"]).T}
    if prefix + ".bias" in sd:
        p["b"] = _n(sd[prefix + ".bias"])
    return p


def asr_params_from_state(sd: Dict[str, torch.Tensor]) -> Tree:
    """``LAS.state_dict()`` (or any dict of tensors under its keys, such as
    gradients) -> the JAX ``models.las`` tree of float32 numpy arrays: the
    inverse of ``asr_state_from_params``, with ``b = bias_ih + bias_hh``."""
    def bi(prefix):
        return {"fwd": _lstm_from(sd, prefix, "_l0"), "bwd": _lstm_from(sd, prefix, "_l0_reverse")}

    return {
        "encoder": {"pblstm1": bi("encoder.blstm_1.layer"), "pblstm2": bi("encoder.blstm_2.layer"),
                    "pblstm3": bi("encoder.blstm_3.layer"), "blstm4": bi("encoder.blstm_4")},
        "attention": {"phi": _linear_from(sd, "attention.phi"),
                      "psi": _linear_from(sd, "attention.psi")},
        "decoder": {"layer1": _lstm_from(sd, "decoder.layer_1", ""),
                    "layer2": _lstm_from(sd, "decoder.layer_2", "")},
        "embed": {"table": _n(sd["embed.weight"])},
        "char_trans": _linear_from(sd, "char_trans"),
    }


def asr_leaf_layout(key: str, shape: Tuple[int, ...]) -> Tuple[Tuple[int, ...], bool]:
    """The JAX leaf behind ``LAS.state_dict()[key]`` of torch ``shape``: (its
    shape, whether the torch tensor is that leaf transposed).
    ``asr_state_from_params`` transposes every matrix (``w [in, out]`` ->
    ``weight [out, in]``) but the embedding table; the biases are vectors
    (``bias_ih`` and ``bias_hh`` both stand for the one ``b``).  Tensor
    parallelism reads the JAX package's sharding rule on these shapes."""
    transposed = len(shape) == 2 and key != "embed.weight"
    return (tuple(shape)[::-1] if transposed else tuple(shape)), transposed


def tae_state_from_params(tree: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``models.text_autoencoder`` tree -> ``TextAutoencoder.state_dict()``."""
    enc = tree["encoder"]
    out: Dict[str, torch.Tensor] = {"encoder.emb.weight": _f(enc["emb"]["table"])}
    for i in range(len(enc) - 1):
        _lstm_to(enc[f"bilstm{i + 1}"]["fwd"], "encoder.blstm", f"_l{i}", out)
        _lstm_to(enc[f"bilstm{i + 1}"]["bwd"], "encoder.blstm", f"_l{i}_reverse", out)
    return out


def tae_params_from_state(sd: Dict[str, torch.Tensor]) -> Tree:
    """The inverse of ``tae_state_from_params`` (``b = bias_ih + bias_hh``)."""
    n = sum(k.startswith("encoder.blstm.weight_ih_l") and not k.endswith("_reverse") for k in sd)
    enc: Tree = {"emb": {"table": _n(sd["encoder.emb.weight"])}}
    for i in range(n):
        enc[f"bilstm{i + 1}"] = {"fwd": _lstm_from(sd, "encoder.blstm", f"_l{i}"),
                                 "bwd": _lstm_from(sd, "encoder.blstm", f"_l{i}_reverse")}
    return {"encoder": enc}


_MLP = (("fc1", "0"), ("fc2", "2"), ("fc3", "4"))  # JAX key, index in the reference's Sequential


def sae_state_from_params(params: Tree, bn_state: Optional[Tree] = None
                          ) -> Dict[str, torch.Tensor]:
    """JAX ``models.speech_autoencoder`` (params, bn_state) ->
    ``SpeechAutoencoder.state_dict()``; conv kernels HWIO -> OIHW.  Without
    ``bn_state`` the running statistics are left out (load with
    ``strict=False``)."""
    out: Dict[str, torch.Tensor] = {}
    for name, conv in params["encoder"].items():
        pre = f"encoder.conv_{name[len('conv'):]}"
        out[f"{pre}.0.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(conv["w"], np.float32).transpose(3, 2, 0, 1)))
        out[f"{pre}.1.weight"] = _f(conv["bn_scale"])
        out[f"{pre}.1.bias"] = _f(conv["bn_bias"])
        if bn_state is not None:
            out[f"{pre}.1.running_mean"] = _f(bn_state[name]["mean"])
            out[f"{pre}.1.running_var"] = _f(bn_state[name]["var"])
    for ours, theirs in _MLP:
        _linear_to(params["decoder"][ours], f"decoder.core.{theirs}", out)
    return out


def sae_params_from_state(sd: Dict[str, torch.Tensor]) -> Tuple[Tree, Tree]:
    """``SpeechAutoencoder.state_dict()`` -> the JAX (params, bn_state); conv
    kernels OIHW -> HWIO.  ``bn_state`` holds the layers whose running
    statistics ``sd`` has (none for a dict of gradients or accumulators)."""
    params: Tree = {"encoder": {}, "decoder": {}}
    bn_state: Tree = {}
    n = sum(k.endswith(".0.weight") and k.startswith("encoder.conv_") for k in sd)
    for i in range(1, n + 1):
        pre = f"encoder.conv_{i}"
        params["encoder"][f"conv{i}"] = {
            "w": np.ascontiguousarray(_n(sd[f"{pre}.0.weight"]).transpose(2, 3, 1, 0)),
            "bn_scale": _n(sd[f"{pre}.1.weight"]), "bn_bias": _n(sd[f"{pre}.1.bias"])}
        if f"{pre}.1.running_mean" in sd:
            bn_state[f"conv{i}"] = {"mean": _n(sd[f"{pre}.1.running_mean"]),
                                    "var": _n(sd[f"{pre}.1.running_var"])}
    for ours, theirs in _MLP:
        params["decoder"][ours] = _linear_from(sd, f"decoder.core.{theirs}")
    return params, bn_state


def disc_state_from_params(tree: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``models.discriminator`` tree -> ``Discriminator.state_dict()``."""
    out: Dict[str, torch.Tensor] = {}
    for ours, theirs in _MLP:
        _linear_to(tree[ours], f"core.{theirs}", out)
    return out


def disc_params_from_state(sd: Dict[str, torch.Tensor]) -> Tree:
    return {ours: _linear_from(sd, f"core.{theirs}") for ours, theirs in _MLP}


def charlm_state_from_params(tree: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``models.charlm`` tree -> ``CharLM.state_dict()``."""
    out: Dict[str, torch.Tensor] = {"emb.weight": _f(tree["emb"]["table"])}
    _gru_to(tree["gru1"], "layer_1", out)
    _gru_to(tree["gru2"], "layer_2", out)
    _linear_to(tree["out"], "out", out)
    return out


def _gru_from(sd, prefix: str) -> Tree:
    return {"w_ih": _n(sd[prefix + ".weight_ih"]).T, "w_hh": _n(sd[prefix + ".weight_hh"]).T,
            "b_ih": _n(sd[prefix + ".bias_ih"]), "b_hh": _n(sd[prefix + ".bias_hh"])}


def charlm_params_from_state(sd: Dict[str, torch.Tensor]) -> Tree:
    """``CharLM.state_dict()`` (or gradients, or optimizer slots under its
    keys) -> the JAX ``models.charlm`` tree: the inverse of
    ``charlm_state_from_params``."""
    return {"emb": {"table": _n(sd["emb.weight"])}, "gru1": _gru_from(sd, "layer_1"),
            "gru2": _gru_from(sd, "layer_2"), "out": _linear_from(sd, "out")}


#: model key of a joint tree -> state_dict-like dict -> its JAX parameter tree
PARAMS_FROM_STATE = {"asr": asr_params_from_state, "tae": tae_params_from_state,
                     "sae": lambda sd: sae_params_from_state(sd)[0],
                     "disc": disc_params_from_state, "char_lm": charlm_params_from_state}
STATE_FROM_PARAMS = {"asr": asr_state_from_params, "tae": tae_state_from_params,
                     "sae": sae_state_from_params, "disc": disc_state_from_params,
                     "char_lm": charlm_state_from_params}


def tree_leaves(tree: Tree) -> List[np.ndarray]:
    """The leaves of a nested dict in ``jax.tree.leaves`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _masked_leaves(tree: Tree, prefixes: Optional[Sequence[Tuple[str, ...]]],
                   path: Tuple[str, ...] = ()) -> List[np.ndarray]:
    """``tree_leaves`` of the leaves whose key path starts with one of
    ``prefixes`` (all of them when None): what ``optax.masked`` keeps."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _masked_leaves(tree[k], prefixes, path + (k,))]
    keep = prefixes is None or any(path[: len(p)] == tuple(p) for p in prefixes)
    return [tree] if keep else []


def _joint_tree(models: Dict, acc: Dict[str, torch.Tensor], prefixed: bool) -> Tree:
    """{model key: JAX tree} of per-name tensors ``acc``, named ``<model
    key>.<state_dict key>`` (or the bare state_dict key when not
    ``prefixed``); a parameter that ``acc`` lacks (the frozen ``bias_hh``, a
    masked-out subtree) counts as zero."""
    return {key: PARAMS_FROM_STATE[key](
        {k: acc.get(f"{key}.{k}" if prefixed else k, torch.zeros_like(v))
         for k, v in m.state_dict().items() if "running_" not in k})
        for key, m in models.items()}


def _head(opt) -> List[np.ndarray]:
    """The optax state's scalar leaves before the slots: the three NaN-skip
    counters, with accumulation ``mini_step`` and ``gradient_step``, then
    Adam's ``count``."""
    leaves = [t.detach().cpu().numpy()
              for t in (opt.notfinite_count, opt.last_finite, opt.total_notfinite)]
    if opt.accum_steps > 1:
        leaves += [np.asarray(opt.mini_step, np.int32), np.asarray(opt.gradient_step, np.int32)]
    if opt.opt_type == "adam":
        leaves.append(opt.count.detach().cpu().numpy())
    return leaves


def opt_state_leaves(opt, models: Dict, prefixes: Optional[Sequence[Tuple[str, ...]]] = None,
                     prefixed: bool = True) -> List[np.ndarray]:
    """The state of an optimizer over the joint parameters of ``models``
    ({"asr": LAS, "tae": ...}; ``opt.params`` named ``<model key>.<state_dict
    key>``) as the leaves of the JAX package's optax state for the joint tree
    (``checkpoint.save_opt_state`` writes them), in ``jax.tree.leaves``
    order: ``_head``, each slot over the tree masked to the key-path
    ``prefixes`` (``optax.masked``: the frozen leaves hold no slot),
    transposed like the weights, the schedule's ``count`` when the rate is
    scheduled, and with accumulation ``acc_grads`` over EVERY leaf (``MultiSteps``
    wraps the masked chain, so the frozen leaves' running mean is kept too)."""
    leaves = _head(opt)
    for slot in opt.slots:
        leaves += _masked_leaves(_joint_tree(models, opt.state[slot], prefixed), prefixes)
    if opt.scheduled:
        leaves.append(np.asarray(opt.sched_count, np.int32))
    if opt.accum_steps > 1:
        leaves += tree_leaves(_joint_tree(models, opt.acc_grads, prefixed))
    return leaves


def _fill(node, it, prefixes, path=()):
    """``node`` (a zero tree) with the leaves under ``prefixes`` taken from ``it``."""
    if isinstance(node, dict):
        return {k: _fill(node[k], it, prefixes, path + (k,)) for k in sorted(node)}
    keep = prefixes is None or any(path[: len(p)] == tuple(p) for p in prefixes)
    return np.asarray(next(it), np.float32) if keep else node


def _load_named(dest: Dict[str, torch.Tensor], models: Dict, tree: Tree, prefixed: bool) -> None:
    """Copy a joint tree into the per-name tensors ``dest`` (those it holds)."""
    for key in models:
        for k, t in STATE_FROM_PARAMS[key](tree[key]).items():
            name = f"{key}.{k}" if prefixed else k
            if name in dest:
                dest[name].copy_(t)


def load_opt_state_leaves(opt, models: Dict, prefixes, leaves: List[np.ndarray],
                          prefixed: bool = True) -> bool:
    """Set ``opt``'s state from ``opt_state_leaves``-ordered leaves (either
    package's file).  A leaf count that does not fit (another optimizer
    type, schedule or accumulation) leaves ``opt`` fresh and returns False,
    as the JAX package does; a leaf of the wrong shape raises."""
    zeros = _joint_tree(models, {}, prefixed)
    like = _masked_leaves(zeros, prefixes)
    every = tree_leaves(zeros) if opt.accum_steps > 1 else []
    n_head = len(_head(opt))
    n_slots = len(like) * len(opt.slots)
    if len(leaves) != n_head + n_slots + int(opt.scheduled) + len(every):
        return False
    tail = leaves[n_head + n_slots + int(opt.scheduled):]
    for got, want in zip(leaves[n_head:n_head + n_slots] + tail, like * len(opt.slots) + every):
        if np.shape(got) != want.shape:
            raise ValueError(f"optimizer state leaf of shape {np.shape(got)}, the model has "
                             f"{want.shape}")
    dev = opt.notfinite_count.device
    head = iter(leaves[:n_head])
    opt.notfinite_count = torch.tensor(int(next(head)), dtype=torch.int32, device=dev)
    opt.last_finite = torch.tensor(bool(next(head)), dtype=torch.bool, device=dev)
    opt.total_notfinite = torch.tensor(int(next(head)), dtype=torch.int32, device=dev)
    if opt.accum_steps > 1:
        opt.mini_step, opt.gradient_step = int(next(head)), int(next(head))
    if opt.opt_type == "adam":
        opt.count = torch.tensor(int(next(head)), dtype=torch.int32, device=dev)
    for i, slot in enumerate(opt.slots):
        part = iter(leaves[n_head + i * len(like): n_head + (i + 1) * len(like)])
        _load_named(opt.state[slot], models, _fill(zeros, part, prefixes), prefixed)
    if opt.scheduled:
        opt.sched_count = int(leaves[n_head + n_slots])
    if every:
        _load_named(opt.acc_grads, models, _fill(zeros, iter(tail), None), prefixed)
    return True


def asr_opt_state_leaves(opt, model) -> List[np.ndarray]:
    """``opt_state_leaves`` for the ASR trainer's optimizer, whose parameters
    are named as ``model.state_dict()`` is."""
    return opt_state_leaves(opt, {"asr": model}, None, prefixed=False)


def load_asr_opt_state_leaves(opt, model, leaves: List[np.ndarray]) -> bool:
    return load_opt_state_leaves(opt, {"asr": model}, None, leaves, prefixed=False)


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


def _bilstm(rng, in_dim: int, hidden: int) -> Tree:
    return {"fwd": _lstm(rng, in_dim, hidden), "bwd": _lstm(rng, in_dim, hidden)}


def init_tae_numpy(seed: int, cfg: TAEConfig) -> Tree:
    rng = np.random.default_rng(seed)
    enc: Tree = {"emb": {"table": rng.standard_normal((cfg.vocab_size, cfg.emb_dim))
                         .astype(np.float32)}}
    in_dim = cfg.emb_dim
    for i in range(cfg.num_layers):
        enc[f"bilstm{i + 1}"] = _bilstm(rng, in_dim, cfg.state_size)
        in_dim = 2 * cfg.state_size
    return {"encoder": enc}


def init_sae_numpy(seed: int, cfg: SAEConfig) -> Tuple[Tree, Tree]:
    """-> (params, bn_state), as ``models.speech_autoencoder.init_sae``."""
    rng = np.random.default_rng(seed)
    params: Tree = {"encoder": {}, "decoder": {}}
    state: Tree = {}
    in_ch = 1
    for i, ((kh, kw), nf) in enumerate(zip(cfg.kernel_sizes, cfg.num_filters)):
        w = rng.standard_normal((kh, kw, in_ch, nf)) / np.sqrt(in_ch * kh * kw)
        params["encoder"][f"conv{i + 1}"] = {"w": w.astype(np.float32),
                                             "bn_scale": np.ones((nf,), np.float32),
                                             "bn_bias": np.zeros((nf,), np.float32)}
        state[f"conv{i + 1}"] = {"mean": np.zeros((nf,), np.float32),
                                 "var": np.ones((nf,), np.float32)}
        in_ch = nf
    d_in = cfg.enc_out_dim + cfg.listener_out_dim
    params["decoder"] = {"fc1": _linear(rng, d_in, d_in), "fc2": _linear(rng, d_in, d_in),
                         "fc3": _linear(rng, d_in, cfg.frames_per_step * cfg.feature_dim)}
    return params, state


def init_disc_numpy(seed: int, cfg: DiscriminatorConfig) -> Tree:
    rng = np.random.default_rng(seed)
    return {"fc1": _linear(rng, cfg.in_dim, cfg.hidden_dim),
            "fc2": _linear(rng, cfg.hidden_dim, cfg.hidden_dim),
            "fc3": _linear(rng, cfg.hidden_dim, 1)}
