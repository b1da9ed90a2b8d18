"""Batch transcription CLI over the Transcriber API, on a GPU.

    python -m ss_asr_tpu_torch.cli.transcribe CKPT utt1.wav utt2.wav ... --beam 1
    python -m ss_asr_tpu_torch.cli.transcribe CKPT --config conf/exp.yaml \
        --lm char_lm.npz --beam 1 --lm-weight 0.1 --out hyps.tsv fbank1.npy utt2.wav

Port of ``ss_asr_tpu/cli/transcribe.py``: inputs are ``.wav`` files (any
rate; resampled to ``--sr``) or ``[T, n_mels]`` ``.npy`` fbanks, decoded in
batches of ``--batch`` with greedy decoding; the output is
``path<TAB>transcript`` per line.  ``--device`` (default ``cuda``) picks
the device; a missing GPU is an error.  ``--long``, ``--detail`` and
``--nbest`` > 1 are not ported yet and exit naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
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
                        help="beam size (default: config decode_beam_size, else greedy); "
                             "only 1 is ported")
    parser.add_argument("--lm-weight", type=float, default=None,
                        help="fusion weight (default: config decode_lm_weight)")
    parser.add_argument("--max-steps", type=int, default=200)
    parser.add_argument("--sr", type=int, default=22050,
                        help="frontend sample rate (wavs are resampled)")
    parser.add_argument("--batch", type=int, default=8, help="decode batch size")
    parser.add_argument("--out", default=None,
                        help="write path<TAB>transcript lines here (default stdout)")
    parser.add_argument("--long", action="store_true", dest="long_form",
                        help="long-form mode (not ported yet)")
    parser.add_argument("--window-s", type=float, default=20.0)
    parser.add_argument("--overlap-s", type=float, default=2.0)
    parser.add_argument("--vad", choices=["energy"], default=None)
    parser.add_argument("--detail", action="store_true",
                        help="n-best JSON lines with timestamps (not ported yet)")
    parser.add_argument("--nbest", type=int, default=1,
                        help="hypotheses per input; > 1 is not ported yet")
    parser.add_argument("--device", default="cuda",
                        help="torch device to decode on (default cuda)")
    args = parser.parse_args(argv)

    from ss_asr_tpu_torch.api import DETAIL_TODO, LONG_TODO

    if args.long_form:
        raise SystemExit(f"--long is not ported yet: {LONG_TODO}")
    if args.detail or args.nbest > 1:
        raise SystemExit(f"--detail / --nbest are not ported yet: {DETAIL_TODO}")

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
        for i in range(0, len(args.inputs), args.batch):
            chunk = args.inputs[i : i + args.batch]
            for path, hyp in zip(chunk, t.transcribe_fbank(chunk_fbanks(chunk))):
                print(f"{path}\t{hyp}", file=sink, flush=True)
    finally:
        if args.out:
            sink.close()


if __name__ == "__main__":
    main()
