"""Corpus preprocessing CLI, on a GPU: wav + text -> fbank .npy files + index.tsv.

    python -m ss_asr_tpu_torch.cli.preprocess malromur <output_dir> <index> <wav_dir>
    python -m ss_asr_tpu_torch.cli.preprocess generic  <output_dir> <wav_dir> <txt_dir>

Port of ``ss_asr_tpu/cli/preprocess.py``: the same sub-commands, ``--sr``
and ``--pad-to-max``, plus ``--device`` (default ``cuda``; a missing GPU is
an error).  The same ``index.tsv`` rows in the same order, and the same
fbank files within the frontend's tolerance.

* Features come from the batched frontend (``ops.frontend``) on the device,
  in (64, bucketed-length) buffers: on the card the fused frontend kernel
  (``csrc/frontend.cu``) does the work, the host threads only do IO, and
  each flush's result comes back with one copy.
* No global zero-padding pass over the corpus: the index stores true frame
  counts and the training loader pads per batch.  ``--pad-to-max`` restores
  the reference's layout.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from ss_asr_tpu_torch.data.audio import DEFAULT_SR, load_wav
from ss_asr_tpu_torch.vocab import normalize_string

N_JOBS = 12  # IO threads (reference used 12 feature processes)


#: signal-length bucket, in samples (1.28 s @ 16 kHz): wav lengths round up
#: to a multiple of this, so that a corpus runs a handful of buffer shapes
SIG_BUCKET = 20480


def _emit_fbanks(
    items: List[Tuple[str, str, str]],
    processed_dir: str,
    sr: int,
    batch_size: int = 64,
    device: str = "cuda",
) -> List[Tuple]:
    """items: (text, wav_path, out_stem). Returns index rows.

    IO runs on a thread pool; features run on ``device`` through the
    batched frontend over (batch_size, bucketed-length) buffers.  The last
    partial group of a bucket is padded to batch_size rows of one sample, so
    the shapes repeat.  Each row's valid frames equal the one-shot
    per-signal frontend (per-row end reflection in ``log_mel_fbank_batch``).
    """
    import torch

    from ss_asr_tpu_torch.ops.frontend import log_mel_fbank_batch

    fbank_dir = os.path.join(processed_dir, "fbanks")
    os.makedirs(fbank_dir, exist_ok=True)

    def load(one):
        text, wav_path, stem = one
        try:
            _, y = load_wav(wav_path, target_sr=sr)
        except Exception as e:
            print(f"Error reading wav: {wav_path}. Sample is omitted. ({e})", file=sys.stderr)
            return None
        return (text, wav_path, stem, y)

    rows: List[Tuple] = []
    buckets: dict = {}  # n_pad -> list of (text, wav_path, stem, y)

    def flush(n_pad: int, group: list) -> None:
        buf = np.zeros((batch_size, n_pad), dtype=np.float32)
        ns = np.ones((batch_size,), dtype=np.int32)
        for i, (_, _, _, y) in enumerate(group):
            buf[i, : y.shape[0]] = y
            ns[i] = y.shape[0]
        with torch.inference_mode():
            fb, fl = log_mel_fbank_batch(torch.from_numpy(buf).to(device),
                                         torch.from_numpy(ns).to(device), sr)
        fb, fl = fb.cpu().numpy(), fl.cpu().numpy()
        for i, (text, wav_path, stem, _) in enumerate(group):
            clean_text, s_len = normalize_string(text)
            fbank = fb[i, : fl[i]]
            out_path = os.path.join(fbank_dir, stem + ".npy")
            np.save(out_path, fbank)
            rows.append((clean_text, out_path, s_len, fbank.shape[0], "na", wav_path))
            if len(rows) % 500 == 0:
                print(f"  processed {len(rows)} utterances", file=sys.stderr)

    with ThreadPoolExecutor(max_workers=N_JOBS) as ex:
        for loaded in ex.map(load, items):
            if loaded is None:
                continue
            n_pad = max(SIG_BUCKET, -(-loaded[3].shape[0] // SIG_BUCKET) * SIG_BUCKET)
            group = buckets.setdefault(n_pad, [])
            group.append(loaded)
            if len(group) == batch_size:
                flush(n_pad, buckets.pop(n_pad))
    for n_pad, group in sorted(buckets.items()):
        flush(n_pad, group)
    return rows


def _write_index(rows: List[Tuple], processed_dir: str, pad_to_max: bool) -> str:
    print("Sorting by frame length...")
    rows = sorted(rows, key=lambda r: r[3])
    index_path = os.path.join(processed_dir, "index.tsv")
    with open(index_path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write("\t".join(str(a) for a in r) + "\n")
    if pad_to_max and rows:
        max_len = rows[-1][3]
        print(f"Zero-padding all fbanks to max_len={max_len} (reference layout)")
        for r in rows:
            fb = np.load(r[1])
            padded = np.zeros((max_len, fb.shape[1]), dtype=fb.dtype)
            padded[: fb.shape[0]] = fb
            np.save(r[1], padded)
    return index_path


def preprocess_malromur(
    index: str, wav_dir: str, processed_dir: Optional[str] = None,
    sr: int = DEFAULT_SR, pad_to_max: bool = False, device: str = "cuda",
) -> str:
    """Málrómur corpus: the rows of its CSV index whose classification
    column is 'correct'."""
    processed_dir = processed_dir or os.path.join("data", "processed")
    os.makedirs(processed_dir, exist_ok=True)
    items: List[Tuple[str, str, str]] = []
    with open(index, "r", encoding="utf-8") as f:
        for line in f:
            d = line.rstrip().split(",")
            if len(d) > 7 and d[7] == "correct":
                items.append((d[5], os.path.join(wav_dir, d[0] + ".wav"), d[0]))
    print(f"Málrómur: {len(items)} verified utterances")
    rows = _emit_fbanks(items, processed_dir, sr, device=device)
    return _write_index(rows, processed_dir, pad_to_max)


def preprocess_generic(
    txt_dir: str, wav_dir: str, processed_dir: Optional[str] = None,
    sr: int = DEFAULT_SR, pad_to_max: bool = False, device: str = "cuda",
) -> str:
    """Generic corpus: parallel <stem>.txt / <stem>.wav directories."""
    processed_dir = processed_dir or os.path.join("data", "processed")
    os.makedirs(processed_dir, exist_ok=True)
    items: List[Tuple[str, str, str]] = []
    for fname in sorted(os.listdir(txt_dir)):
        stem, ext = os.path.splitext(fname)
        if ext != ".txt":
            continue
        with open(os.path.join(txt_dir, fname), "r", encoding="utf-8") as f:
            text = "".join(s for s in f).strip()
        items.append((text, os.path.join(wav_dir, stem + ".wav"), stem))
    print(f"Generic corpus: {len(items)} utterances")
    rows = _emit_fbanks(items, processed_dir, sr, device=device)
    return _write_index(rows, processed_dir, pad_to_max)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ss_asr_tpu_torch.preprocess")
    sub = parser.add_subparsers(dest="dataset", required=True)

    m = sub.add_parser("malromur")
    m.add_argument("output_dir", type=str)
    m.add_argument("index", type=str)
    m.add_argument("wav_dir", type=str)

    g = sub.add_parser("generic")
    g.add_argument("output_dir", type=str)
    g.add_argument("wav_dir", type=str)
    g.add_argument("txt_dir", type=str)

    for p in (m, g):
        p.add_argument("--sr", type=int, default=DEFAULT_SR,
                       help="target sample rate (default 22050)")
        p.add_argument("--pad-to-max", action="store_true",
                       help="zero-pad every fbank to the corpus max (reference layout)")
        p.add_argument("--device", default="cuda",
                       help="torch device the frontend runs on (default cuda)")

    args = parser.parse_args(argv)
    import torch

    from ss_asr_tpu_torch.ops.kernels.frontend import LAUNCHES

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available")
    if args.dataset == "malromur":
        print("Preprocessing Malromur")
        preprocess_malromur(args.index, args.wav_dir, args.output_dir,
                            sr=args.sr, pad_to_max=args.pad_to_max, device=args.device)
    else:
        print("Preprocessing a generic dataset")
        preprocess_generic(args.txt_dir, args.wav_dir, args.output_dir,
                           sr=args.sr, pad_to_max=args.pad_to_max, device=args.device)
    print(f"Frontend on {args.device}: {LAUNCHES['fbank']} kernel launches")


if __name__ == "__main__":
    main()
