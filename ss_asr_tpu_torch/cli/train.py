"""Training CLI, on a GPU.

    python -m ss_asr_tpu_torch.cli.train <type> <name> <config> [logdir] [ckpdir] \
        [--seed N] [--verbose B] [--device cuda]

Port of ``ss_asr_tpu/cli/train.py``: the same positional arguments and
options, plus ``--device`` (default ``cuda``; a missing GPU is an error).
Checkpoints land in ``<ckpdir>/<name>/`` in the JAX package's layout, so
either package resumes from the other's.  ``type`` is ``ASRTrainer``,
``ASRTester`` (decode ``asr.test_index`` with ``<ckpdir>/<name>/asr.npz``
and, when it exists, ``char_lm.npz``), ``LMTrainer`` / ``CHARLMTrainer``
(the char-LM), ``TAETrainer``, ``SAETrainer``, ``AdvTrainer`` /
``ADVTrainer`` or ``Seed`` (the TAE / ADV / SAE chain over the ASR relay
files).

Data parallel: a config with ``parallel: {distributed: true, n_data: auto}``
brings up ``torch.distributed`` from ``torchrun``'s environment before the
trainers are built, one rank per device (``parallel/mesh.py``)::

    python -m torch.distributed.run --nproc-per-node N -m ss_asr_tpu_torch.cli.train ...

Tensor parallel (``ASRTrainer``): ``parallel: {distributed: true, n_data: D,
n_model: M}`` under ``--nproc-per-node D*M`` (ranks that share a card run
gloo; one card a rank runs NCCL).
"""

from __future__ import annotations

import argparse
import random

import numpy as np

TYPES = ["ASRTrainer", "ASRTester", "LMTrainer", "CHARLMTrainer",
         "TAETrainer", "SAETrainer", "AdvTrainer", "ADVTrainer", "Seed"]


def _parse_bool(s: str) -> bool:
    """argparse type=bool is a trap: bool("False") is True."""
    return s.lower() not in ("false", "0", "no", "")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ss_asr_tpu_torch.train")
    parser.add_argument("type", metavar="t", type=str, nargs="?", choices=TYPES,
                        default="ASRTrainer", help="The type of training/testing to perform")
    parser.add_argument("name", metavar="n", type=str, nargs="?", default="experiment_1")
    parser.add_argument("config", metavar="c", type=str, nargs="?", default="./conf/default.yaml")
    parser.add_argument("logdir", type=str, nargs="?", default="runs/")
    parser.add_argument("ckpdir", type=str, nargs="?", default="result/")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--verbose", type=_parse_bool, default=True)
    parser.add_argument("--device", default="cuda", help="torch device to train on (default cuda)")
    paras = parser.parse_args(argv)

    import torch

    if paras.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {paras.device}: CUDA is not available")

    import yaml

    with open(paras.config, "r") as f:
        config = yaml.safe_load(f)
    random.seed(paras.seed)
    np.random.seed(paras.seed)

    distributed = bool((config.get("parallel") or {}).get("distributed"))
    if distributed:
        from ss_asr_tpu_torch.parallel import mesh as pmesh

        paras.device = str(pmesh.init_process_group(paras.device))
    try:
        _run(config, paras)
    finally:
        if distributed:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(config, paras):
    from ss_asr_tpu_torch.train import TRAINERS, asr_seed_train

    if paras.type == "Seed":
        asr_seed_train(config, paras, device=paras.device)
        return
    solver = TRAINERS[paras.type](config, paras, device=paras.device)
    solver.load_data()
    solver.set_model()
    solver.exec()
    solver.close()


if __name__ == "__main__":
    main()
