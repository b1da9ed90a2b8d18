"""Rank processes of the port's data-parallel tests (test_torch_parallel.py,
test_torch_dp.py, and on the card test_torch_gpu.py).

``run_ranks(fn, world, out_dir, *args)`` is ``chip_smoke.run_ranks`` on the
CPU: ``world`` processes started with the ``spawn`` start method (the test
process holds JAX's threads, which ``fork`` would copy mid-flight), each with
one torch thread, ``torchrun``'s environment on a free local port and a gloo
process group; each runs ``fn(rank, world, device, *args)`` and pickles what
it returns.  The ranks are joined within RANK_TIMEOUT_S; a rank still alive
then is killed and the run fails, so no test hangs on a collective that one
rank never reaches.  The functions below import torch and the port only: a
spawned rank imports no JAX.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

import chip_smoke

RANK_TIMEOUT_S = 120.0


def run_ranks(fn, world: int, out_dir, *args, device: str = "cpu") -> list:
    return chip_smoke.run_ranks(fn, world, out_dir, *args, device=device,
                                timeout=RANK_TIMEOUT_S)


# ----------------------------------------------------------------------
# what the ranks run


def collectives(rank, world, dev):
    """The primitives of parallel/mesh.py on distinct per-rank values."""
    from ss_asr_tpu_torch.parallel import mesh as pmesh

    p = [torch.nn.Parameter(torch.full((2, 3), float(rank + 1))),
         torch.nn.Parameter(torch.zeros(4)),  # no gradient on any rank
         torch.nn.Parameter(torch.zeros(5))]  # a gradient on rank 0 alone
    p[0].grad = torch.full((2, 3), float(10 * (rank + 1)))
    if rank == 0:
        p[2].grad = torch.arange(5, dtype=torch.float32)
    loss, extra = pmesh.average_gradients(p, [torch.tensor(float(rank)),
                                               torch.full((3,), float(rank))])
    b = [torch.full((3,), float(rank + 7)), torch.full((2,), float(rank), dtype=torch.float64)]
    pmesh.broadcast_(b)
    return {"grads": [q.grad.numpy().copy() for q in p], "loss": float(loss),
            "extra": extra.numpy().copy(), "bcast": [t.numpy().copy() for t in b],
            "min": pmesh.all_reduce_int(rank + 3, "min", dev),
            "max": pmesh.all_reduce_int(rank + 3, "max", dev),
            "rank": pmesh.process_index(), "world": pmesh.process_count()}


def _paras(tmp, name, ckpdir="result"):
    from ss_asr_tpu_torch.train.solver import make_paras

    return make_paras(name=name, logdir=os.path.join(tmp, "runs"),
                      ckpdir=os.path.join(tmp, ckpdir), seed=1, verbose=False)


def _rows(a, rank, world, dev):
    b = a.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(a[rank * b:(rank + 1) * b])).to(dev)


def launches():
    """Every kernel wrapper's launch counter (all zero on the CPU)."""
    from ss_asr_tpu_torch.ops.kernels import beam, decode, frontend, lstm, spell

    return {k: v for m in (lstm, decode, beam, spell, frontend) for k, v in m.LAUNCHES.items()}


def asr_steps(rank, world, dev, cases):
    """Each case: ``(config, tmp, name, [(x, x_lens, y) global batches])``;
    the trainer starts from ``<tmp>/result/<name>/asr.npz`` and steps on
    this rank's rows of each batch -> [(losses, params tree, optimizer
    leaves, the kernels' launches)]."""
    from ss_asr_tpu_torch import convert
    from ss_asr_tpu_torch.train.asr_trainer import ASRTrainer

    out = []
    for config, tmp, name, batches in cases:
        t = ASRTrainer(config, _paras(tmp, name), device=str(dev))
        t.set_model()
        before = launches()
        losses = [float(t.step(*(_rows(a, rank, world, dev) for a in (x, xl)),
                               _rows(y, rank, world, dev).long())[0])
                  for x, xl, y in batches]
        after = launches()
        out.append((losses, t.params_tree(), convert.asr_opt_state_leaves(t.optim, t.model),
                    {k: after[k] - before[k] for k in after}))
    return out


def asr_loops(rank, world, dev, tmp, configs):
    """The ASR trainer's loop on each of ``configs`` (name -> config), as a
    user runs it: load_data, set_model, exec, valid, close; then a fresh
    trainer on the same directories -> per name: the logged losses, the
    step, the local batch count, the writer flag, the final and the resumed
    parameters."""
    from ss_asr_tpu_torch.train.asr_trainer import ASRTrainer

    out = {}
    for name, config in configs.items():
        t = ASRTrainer(copy.deepcopy(config), _paras(tmp, name), device=str(dev))
        logs = []
        t.lg.scalar = lambda k, v, s: logs.append((k, float(v)))
        t.lg.image = t.lg.text = lambda *a, **kw: None
        t.load_data()
        t.set_model()
        t.exec()
        t.valid()
        t.close()
        r = ASRTrainer(copy.deepcopy(config), _paras(tmp, name), device=str(dev))
        r.load_data()
        r.set_model()
        out[name] = {
            "train_loss": [v for k, v in logs if k == "train_loss"],
            "eval_loss": [v for k, v in logs if k == "eval_loss"],
            "eval_cer": [v for k, v in logs if k == "eval_cer"],
            "eval_acc": [v for k, v in logs if k == "eval_acc"],
            "step": t.tr.step, "n_local_batches": len(t.train_ds), "is_writer": t.is_writer,
            "host_shard": t.host_shard, "params": t.params_tree(),
            "resumed_step": r.tr.step, "loaded": r.loaded_ckpt, "resumed": r.params_tree(),
            "files": sorted(os.listdir(t.ckpdir)),
            "rank_logs": os.path.isdir(os.path.join(tmp, "runs", name, "asr", f"rank{rank}")),
        }
    return out


def aux_runs(rank, world, dev, tmp, config, batches):
    """The TAE, SAE, ADV and char-LM trainers under data parallelism: one
    step on this rank's rows of ``batches[kind]`` (after set_model), then
    each trainer's loop (exec, close) -> per kind: the step's loss(es), the
    trained trees after it, the loop's step count and the trees after it."""
    from ss_asr_tpu_torch.train.adv_trainer import ADVTrainer
    from ss_asr_tpu_torch.train.lm_trainer import CHARLMTrainer
    from ss_asr_tpu_torch.train.sae_trainer import SAETrainer
    from ss_asr_tpu_torch.train.tae_trainer import TAETrainer

    def trees(t):
        if hasattr(t, "models"):
            out = {k: t.tree(k) for k in t.models if k != "sae"}
            if "sae" in t.models:
                out["sae"] = t.sae_tree()
            return out
        return {"char_lm": t.params_tree()}

    out = {}
    for kind, cls in (("tae", TAETrainer), ("sae", SAETrainer), ("adv", ADVTrainer),
                      ("char_lm", CHARLMTrainer)):
        rows = [_rows(a, rank, world, dev) for a in batches[kind]]
        for phase in ("step", "loop"):
            t = cls(copy.deepcopy(config), _paras(tmp, f"{kind}_{phase}"), device=str(dev))
            t.lg.scalar = t.lg.image = t.lg.text = t.lg.embedding = lambda *a, **kw: None
            t.load_data()
            t.set_model()
            if phase == "step":
                if kind == "tae":
                    got = t.step(rows[0].long(), rows[1].long(), rows[2].long())[0]
                elif kind == "sae":
                    got = t.step(rows[0], rows[1])[0]
                elif kind == "adv":
                    got = torch.stack([*t.d_step(rows[0], rows[1], rows[2].long(),
                                                 rows[3].long()),
                                       t.g_step(rows[0], rows[1])])
                else:
                    got = t.step(rows[0].long())[0]
                out[kind] = {"loss": got.numpy().copy(), "step_trees": trees(t)}
            else:
                t.exec()
                t.close()
                out[kind].update(loop_step=t.tr.step, loop_trees=trees(t))
    return out
