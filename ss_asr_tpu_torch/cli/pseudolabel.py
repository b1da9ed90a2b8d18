"""Self-training data: unlabeled wavs -> a pseudo-labeled corpus, on a GPU.

    python -m ss_asr_tpu_torch.cli.pseudolabel CKPT OUTDIR utt1.wav utt2.wav ... \
        --config conf/exp.yaml --min-avg-logprob -0.6 --beam 8 --lm lm.npz [--device cuda]

Port of ``ss_asr_tpu/cli/pseudolabel.py``: the same arguments, plus
``--device`` (default ``cuda``; a missing GPU is an error).

* Each batch of ``--batch`` wavs (resampled to ``--sr``) runs one bucketed
  frontend call (``ops.frontend.log_mel_fbank_ragged``, kernel K11 on the
  card) and the detailed decode (``Transcriber.transcribe_fbank_detailed``:
  K2, then K6 / K7 or K8 ± the LM, then K9 for the alignment pass whose
  length-normalised log-prob ``avg_logprob`` is the confidence).
* A hypothesis is kept with ``avg_logprob >= --min-avg-logprob`` (0 is
  certain) and at least ``--min-chars`` characters; unreadable or empty
  wavs are skipped and counted.
* The kept utterances become a trainable corpus: their fbanks as
  ``OUTDIR/fbanks/<stem>.npy`` (a stem seen before gets ``-2``, ``-3``, ...)
  and ``OUTDIR/index.tsv`` in the index schema, sorted by frames, which
  every trainer loads (``asr.train_index: OUTDIR/index.tsv``).
* One JSON summary line is printed (counts, confidence, index path); the
  exit code is 1 when inputs were given and none was kept.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ss_asr_tpu_torch.pseudolabel")
    parser.add_argument("checkpoint", help="ASR checkpoint (.npz, JAX tree layout)")
    parser.add_argument("outdir", help="output corpus dir (fbanks/ + index.tsv)")
    parser.add_argument("inputs", nargs="+", help="unlabeled .wav files")
    parser.add_argument("--config", default=None,
                        help="experiment yaml (asr.mdl sizes, decode params)")
    parser.add_argument("--lm", default=None, help="char-LM checkpoint for decode-time fusion")
    parser.add_argument("--beam", type=int, default=None)
    parser.add_argument("--lm-weight", type=float, default=None)
    parser.add_argument("--max-steps", type=int, default=200)
    parser.add_argument("--sr", type=int, default=22050)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--min-avg-logprob", type=float, default=-0.6,
                        help="confidence floor (0 = certain; looser is more data, noisier labels)")
    parser.add_argument("--min-chars", type=int, default=2,
                        help="drop hypotheses shorter than this")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available")
    config = {}
    if args.config:
        import yaml

        with open(args.config) as f:
            config = yaml.safe_load(f) or {}

    from ss_asr_tpu_torch.api import Transcriber
    from ss_asr_tpu_torch.data.audio import load_wav
    from ss_asr_tpu_torch.ops.frontend import log_mel_fbank_ragged
    from ss_asr_tpu_torch.vocab import normalize_string

    kw = {"max_steps": args.max_steps, "sr": args.sr}
    if args.beam is not None:
        kw["beam_size"] = args.beam
    if args.lm_weight is not None:
        kw["lm_weight"] = args.lm_weight
    t = Transcriber.from_checkpoint(args.checkpoint, config=config, lm_path=args.lm,
                                    device=args.device, **kw)

    fbank_dir = os.path.join(args.outdir, "fbanks")
    os.makedirs(fbank_dir, exist_ok=True)

    rows = []
    n_low, n_short, n_bad = 0, 0, 0
    kept_conf = []
    used_names = set()
    for i in range(0, len(args.inputs), args.batch):
        chunk = args.inputs[i : i + args.batch]
        sigs, ok_rows = [], []
        for j, path in enumerate(chunk):
            try:
                _, y = load_wav(path, target_sr=args.sr)
            except Exception as e:  # noqa: BLE001 — skip an unreadable file, keep going
                print(f"Error reading wav: {path}. Skipped. ({e})", file=sys.stderr)
                n_bad += 1
                continue
            y = np.asarray(y, dtype=np.float32)
            if y.size == 0:
                n_bad += 1
                continue
            sigs.append(y)
            ok_rows.append(j)
        if not sigs:
            continue
        fbanks = log_mel_fbank_ragged(sigs, args.sr, n_mels=t.cfg.feature_dim,
                                      min_rows=args.batch, device=t.device)

        hyps = t.transcribe_fbank_detailed(fbanks)
        for (h,), fbank, j in zip(hyps, fbanks, ok_rows):
            path = chunk[j]
            if len(h.text) < args.min_chars:
                n_short += 1
                continue
            if not (h.avg_logprob >= args.min_avg_logprob):
                n_low += 1
                continue
            stem = os.path.splitext(os.path.basename(path))[0]
            # corpora reuse stems across directories (spk1/utt001, spk2/utt001)
            name, k = stem, 1
            while name in used_names:
                k += 1
                name = f"{stem}-{k}"
            used_names.add(name)
            out_path = os.path.join(fbank_dir, name + ".npy")
            np.save(out_path, fbank.astype(np.float32))
            clean_text, s_len = normalize_string(h.text)
            rows.append((clean_text, out_path, s_len, fbank.shape[0],
                         f"pseudo:{h.avg_logprob:.4f}", path))
            kept_conf.append(h.avg_logprob)

    rows.sort(key=lambda r: r[3])  # frame-length order (the index convention)
    index_path = os.path.join(args.outdir, "index.tsv")
    with open(index_path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write("\t".join(str(a) for a in r) + "\n")

    summary = {
        "metric": "pseudolabel",
        "n_in": len(args.inputs),
        "n_kept": len(rows),
        "rejected_low_conf": n_low,
        "rejected_short": n_short,
        "rejected_unreadable": n_bad,
        "mean_avg_logprob": round(float(np.mean(kept_conf)), 4) if kept_conf else None,
        "min_avg_logprob": args.min_avg_logprob,
        "index": index_path,
    }
    print(json.dumps(summary, ensure_ascii=False))
    return 0 if rows or not args.inputs else 1


if __name__ == "__main__":
    sys.exit(main())
