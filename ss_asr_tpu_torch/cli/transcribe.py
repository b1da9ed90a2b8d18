"""Batch transcription CLI over the Transcriber API, on a GPU.

    python -m ss_asr_tpu_torch.cli.transcribe CKPT utt1.wav utt2.wav ...
    python -m ss_asr_tpu_torch.cli.transcribe CKPT --config conf/default.yaml \
        --lm char_lm.npz --beam 8 --lm-weight 0.1 --out hyps.tsv fbank1.npy utt2.wav
    python -m ss_asr_tpu_torch.cli.transcribe CKPT --long --vad energy meeting.wav
    python -m ss_asr_tpu_torch.cli.transcribe CKPT --nbest 3 utt.wav

Port of ``ss_asr_tpu/cli/transcribe.py``: inputs are ``.wav`` files (any
rate; resampled to ``--sr``) or ``[T, n_mels]`` ``.npy`` fbanks, decoded in
batches of ``--batch`` (greedy, or beam per ``--beam`` / the config); the
output is ``path<TAB>transcript`` per line.  ``--long`` decodes each wav in
windows (``--window-s``, ``--overlap-s``, ``--vad energy``); ``--detail``
and ``--nbest`` > 1 print one JSON line per input with the n-best
hypotheses, their scores, confidence and character / word times.
``--device`` (default ``cuda``) picks the device; a missing GPU is an error.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ss_asr_tpu_torch.transcribe")
    parser.add_argument("checkpoint", help="ASR checkpoint (.npz, JAX tree layout)")
    parser.add_argument("inputs", nargs="+", help=".wav or fbank .npy files")
    parser.add_argument("--config", default=None,
                        help="experiment yaml (asr.mdl sizes, decode params, char_lm.mdl); "
                             "omit for the flagship defaults")
    parser.add_argument("--lm", default=None, help="char-LM checkpoint for shallow fusion")
    parser.add_argument("--beam", type=int, default=None,
                        help="beam size (default: config decode_beam_size, else greedy)")
    parser.add_argument("--lm-weight", type=float, default=None,
                        help="fusion weight (default: config decode_lm_weight)")
    parser.add_argument("--max-steps", type=int, default=200)
    parser.add_argument("--sr", type=int, default=22050,
                        help="frontend sample rate (wavs are resampled)")
    parser.add_argument("--batch", type=int, default=8, help="decode batch size")
    parser.add_argument("--out", default=None,
                        help="write path<TAB>transcript lines here (default stdout)")
    parser.add_argument("--long", action="store_true", dest="long_form",
                        help="long-form mode for wav inputs: overlapping windows decoded as "
                             "one batch, transcripts merged over the overlap")
    parser.add_argument("--window-s", type=float, default=20.0,
                        help="--long window length in seconds")
    parser.add_argument("--overlap-s", type=float, default=2.0,
                        help="--long window overlap in seconds")
    parser.add_argument("--vad", choices=["energy"], default=None,
                        help="--long segmentation: cut at low-energy points (pauses)")
    parser.add_argument("--detail", action="store_true",
                        help="one JSON line per input instead of TSV: n-best hypotheses with "
                             "score, avg_logprob confidence and per-char start times (s)")
    parser.add_argument("--nbest", type=int, default=1,
                        help="hypotheses per input; > 1 implies beam decode and JSON lines")
    parser.add_argument("--device", default="cuda",
                        help="torch device to decode on (default cuda)")
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
    from ss_asr_tpu_torch.serve import hypothesis_json

    kw = {"max_steps": args.max_steps, "sr": args.sr}
    if args.beam is not None:
        kw["beam_size"] = args.beam
    if args.lm_weight is not None:
        kw["lm_weight"] = args.lm_weight
    t = Transcriber.from_checkpoint(args.checkpoint, config=config, lm_path=args.lm,
                                    device=args.device, **kw)

    def chunk_fbanks(chunk):
        """.npy rows load directly; wav rows run one bucketed batched
        frontend call (frames equal each row's true-length frontend)."""
        fbs = [None] * len(chunk)
        wav_rows, sigs = [], []
        for j, path in enumerate(chunk):
            if path.endswith(".npy"):
                fb = np.load(path)
                if fb.ndim != 2 or fb.shape[1] != t.cfg.feature_dim:
                    raise SystemExit(f"{path}: expected [T, {t.cfg.feature_dim}] fbank, "
                                     f"got shape {fb.shape}")
                fbs[j] = fb.astype(np.float32)
                continue
            _, y = load_wav(path, target_sr=args.sr)
            y = np.asarray(y, dtype=np.float32)
            if y.size == 0:  # header-only wav: empty transcript
                fbs[j] = np.zeros((0, t.cfg.feature_dim), np.float32)
                continue
            wav_rows.append(j)
            sigs.append(y)
        if sigs:
            fbanks = log_mel_fbank_ragged(sigs, args.sr, n_mels=t.cfg.feature_dim,
                                          min_rows=args.batch, device=t.device)
            for f, j in zip(fbanks, wav_rows):
                fbs[j] = f
        return fbs

    sink = open(args.out, "w") if args.out else sys.stdout
    try:
        if args.long_form:
            if args.detail or args.nbest > 1:
                raise SystemExit("--long and --detail/--nbest are exclusive "
                                 "(windowed merge has no single alignment)")
            for path in args.inputs:
                if path.endswith(".npy"):
                    raise SystemExit(f"{path}: --long takes wav inputs "
                                     "(windows are cut in signal time)")
                _, y = load_wav(path, target_sr=args.sr)
                hyp = t.transcribe_long(np.asarray(y, np.float32), args.sr,
                                        window_s=args.window_s, overlap_s=args.overlap_s,
                                        vad=args.vad)
                print(f"{path}\t{hyp}", file=sink, flush=True)
            return
        for i in range(0, len(args.inputs), args.batch):
            chunk = args.inputs[i : i + args.batch]
            if args.detail or args.nbest > 1:
                rows = t.transcribe_fbank_detailed(chunk_fbanks(chunk), n_best=args.nbest)
                for path, hyps in zip(chunk, rows):
                    print(json.dumps({"path": path, "text": hyps[0].text,
                                      "hypotheses": [hypothesis_json(h, digits=4)
                                                     for h in hyps]},
                                     ensure_ascii=False), file=sink, flush=True)
                continue
            for path, hyp in zip(chunk, t.transcribe_fbank(chunk_fbanks(chunk))):
                print(f"{path}\t{hyp}", file=sink, flush=True)
    finally:
        if args.out:
            sink.close()


if __name__ == "__main__":
    main()
