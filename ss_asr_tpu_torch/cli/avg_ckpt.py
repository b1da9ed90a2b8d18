"""Checkpoint-averaging CLI.

    # average explicit checkpoints
    python -m ss_asr_tpu_torch.cli.avg_ckpt --out avg.npz \
        result/exp/asr.snap-000001000.npz result/exp/asr.snap-000002000.npz

    # average the last K snapshots of a module in a checkpoint dir
    python -m ss_asr_tpu_torch.cli.avg_ckpt --out avg.npz --ckpdir result/exp \
        --module asr --last 5

Port of ``ss_asr_tpu/cli/avg_ckpt.py`` for npz checkpoints (the orbax
backend is not ported): the elementwise mean (``utils.checkpoint
.average_pytrees``) of explicit checkpoints, or of the last ``--last``
step-stamped snapshots that a trainer with ``keep_snapshots: K`` wrote.
The output is an ordinary checkpoint for any consumer (``ASRTester``,
``Transcriber``, a resume).  Runs on the host: no device is touched.
"""

from __future__ import annotations

import argparse

from ss_asr_tpu_torch.utils import checkpoint as ckpt


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ss_asr_tpu_torch.avg_ckpt")
    parser.add_argument("checkpoints", nargs="*", help="explicit checkpoint paths (.npz)")
    parser.add_argument("--out", required=True, help="output checkpoint path (.npz)")
    parser.add_argument("--ckpdir", default=None,
                        help="checkpoint dir holding <module>.snap-* files")
    parser.add_argument("--module", default="asr",
                        help="module id whose snapshots to average (with --ckpdir)")
    parser.add_argument("--last", type=int, default=5,
                        help="how many most-recent snapshots to average (with --ckpdir)")
    args = parser.parse_args(argv)

    if bool(args.checkpoints) == bool(args.ckpdir):
        parser.error("give either explicit checkpoint paths OR --ckpdir, not both/neither")
    paths = args.checkpoints
    if args.ckpdir:
        if args.last < 1:
            parser.error("--last must be >= 1")
        snaps = ckpt.list_snapshots(args.ckpdir, args.module)
        if not snaps:
            parser.error(f"no {args.module}.snap-* checkpoints in {args.ckpdir} "
                         "(train with keep_snapshots: K to record them)")
        paths = [p for _, p in snaps[-args.last:]]

    tree = ckpt.average_pytrees(paths)
    ckpt.save_pytree(args.out, tree)
    print(f"averaged {len(paths)} checkpoint(s) -> {args.out}")
    for p in paths:
        print(f"  {p}")


if __name__ == "__main__":
    main()
