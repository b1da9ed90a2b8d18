"""Convert reference (cadia-lvl/ss_asr) torch checkpoints to this package's.

    python -m ss_asr_tpu_torch.cli.import_ckpt <src> <dest_dir> [--module ID]
    python -m ss_asr_tpu_torch.cli.import_ckpt result/myrun/ result_port/myrun/
    python -m ss_asr_tpu_torch.cli.import_ckpt result_port/myrun/ ref/ --export

Port of ``ss_asr_tpu/cli/import_ckpt.py``.  ``src`` is one ``.cpt`` file or
a reference checkpoint directory (``asr.cpt``, ``asr_best.cpt``,
``char_lm.cpt``, relay files ``asr_1.cpt`` ...).  Each recognised file
becomes ``<dest_dir>/<module_id>[_best].npz``, the npz checkpoint both
packages' trainers, ``Transcriber`` and the tester load; ``tracker.json``
is copied as it is.  ``--export`` goes the other way: npz checkpoints (the
``*_opt.npz`` optimizer states skipped) to reference-keyed ``.cpt`` files.
A file that fails prints a ``SKIP`` line and the exit code is 1.  Runs on
the host: no device is touched.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from typing import Optional

import numpy as np
import torch

from ss_asr_tpu_torch.utils import checkpoint as ckpt
from ss_asr_tpu_torch.utils import torch_import as ti


def _convert_file(src: str, dest_dir: str, module: Optional[str]) -> str:
    mid, tree = ti.import_checkpoint(src, module=module)
    stem = os.path.basename(src).rsplit(".", 1)[0]
    if module is not None:
        # a forced module id names the output, so that the trainers find it
        stem = mid + ("_best" if stem.endswith("_best") else "")
    # otherwise the reference's file name stays (asr_best.cpt -> asr_best.npz)
    out = os.path.join(dest_dir, stem + ".npz")
    ckpt.save_pytree(out, tree)
    return out


def _export_file(src: str, dest_dir: str, module: Optional[str]) -> str:
    tree = ckpt.load_pytree(src)
    stem = os.path.basename(src).rsplit(".", 1)[0]
    mid = module or stem.removesuffix("_best")
    base = "asr" if mid.startswith("asr") else mid
    if base == "asr":
        flat = ti.export_asr(tree)
    elif base == "char_lm":
        flat = ti.export_charlm(tree)
    elif base == "tae":
        flat = ti.export_tae(tree)
    elif base == "sae":
        flat = ti.export_sae(tree["params"], tree["bn_state"])
    elif base in ("adv", "discriminator"):
        flat = ti.export_discriminator(tree)
    else:
        raise ValueError(f"unknown module id: {mid} (pass --module)")
    out = os.path.join(dest_dir, stem + ".cpt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in flat.items()}, out)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ss_asr_tpu_torch.import_ckpt")
    parser.add_argument("src", help=".cpt file or reference ckpt directory")
    parser.add_argument("dest", help="output directory")
    parser.add_argument("--module", default=None, help="force the module id (default: detect)")
    parser.add_argument("--export", action="store_true",
                        help="reverse direction: our .npz -> torch .cpt")
    args = parser.parse_args(argv)

    in_ext = ".npz" if args.export else ".cpt"
    convert = _export_file if args.export else _convert_file

    if os.path.isfile(args.src):
        files = [args.src]
    elif os.path.isdir(args.src):
        if args.module is not None:
            print("--module only applies to a single file, not a directory "
                  "(a directory holds several module kinds)", file=sys.stderr)
            return 1
        # *_opt.npz are optimizer states, not model checkpoints
        files = sorted(os.path.join(args.src, f) for f in os.listdir(args.src)
                       if f.endswith(in_ext) and not f.endswith("_opt.npz"))
        if not files:
            print(f"no {in_ext} files in {args.src}", file=sys.stderr)
            return 1
    else:
        print(f"no such file or directory: {args.src}", file=sys.stderr)
        return 1
    os.makedirs(args.dest, exist_ok=True)
    n_err = 0
    for f in files:
        try:
            out = convert(f, args.dest, args.module)
            print(f"{f} -> {out}")
        except Exception as e:  # keep going; report at the end
            print(f"SKIP {f}: {e}", file=sys.stderr)
            n_err += 1
    tracker = os.path.join(args.src, "tracker.json") if os.path.isdir(args.src) else None
    if tracker and os.path.isfile(tracker) and not args.export:
        shutil.copy(tracker, os.path.join(args.dest, "tracker.json"))
        print(f"{tracker} -> {os.path.join(args.dest, 'tracker.json')}")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
