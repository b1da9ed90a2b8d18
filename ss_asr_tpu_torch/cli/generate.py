"""Char-LM text generation CLI, on a GPU.

    python -m ss_asr_tpu_torch.cli.generate --name N --config C \
        [--start STR] [--length N] [--temp F] [--device cuda]

Port of ``ss_asr_tpu/cli/generate.py``: the same options, plus ``--device``
(default ``cuda``; a missing GPU is an error).  Loads the LM of
``<ckpdir>/<name>/char_lm.npz`` (a fresh seeded one when it is missing, as
the trainer would start), normalises ``--start`` and prints it followed by
``--length`` sampled characters at temperature ``--temp``.
"""

from __future__ import annotations

import argparse

from ss_asr_tpu_torch.cli.train import _parse_bool


def lm_trainer(args):
    """The ``CHARLMTrainer`` of ``args`` (name, config, logdir, ckpdir, seed,
    verbose, device) with its data and model loaded."""
    import torch
    import yaml

    from ss_asr_tpu_torch.train.lm_trainer import CHARLMTrainer
    from ss_asr_tpu_torch.train.solver import make_paras

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available")
    with open(args.config, "r") as f:
        config = yaml.safe_load(f)
    paras = make_paras(args.name, args.logdir, args.ckpdir, args.seed, args.verbose)
    trainer = CHARLMTrainer(config, paras, device=args.device)
    trainer.load_data()
    trainer.set_model()
    return trainer


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--name", type=str, default="newtest")
    parser.add_argument("--config", type=str, default="./conf/default.yaml")
    parser.add_argument("--logdir", type=str, default="runs/")
    parser.add_argument("--ckpdir", type=str, default="result/")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--verbose", type=_parse_bool, default=True)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ss_asr_tpu_torch.generate")
    add_common_args(parser)
    parser.add_argument("--start", type=str, default="pétur helgi hefur aldrei ")
    parser.add_argument("--length", type=int, default=300)
    parser.add_argument("--temp", type=float, default=0.6)
    args = parser.parse_args(argv)

    from ss_asr_tpu_torch.vocab import normalize_string

    trainer = lm_trainer(args)
    start, _ = normalize_string(args.start, append_tokens=False)
    print(trainer.generate(length=args.length, temp=args.temp, start=start))


if __name__ == "__main__":
    main()
