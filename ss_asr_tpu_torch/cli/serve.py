"""HTTP transcription server with dynamic batching, on a GPU.

    python -m ss_asr_tpu_torch.cli.serve asr.npz --config conf/default.yaml \
        --lm char_lm.npz --port 8000 --max-batch 16 --max-wait-ms 5

    curl -s --data-binary @utt.wav http://127.0.0.1:8000/transcribe
    curl -s --data-binary @utt.wav 'http://127.0.0.1:8000/transcribe?detail=1&nbest=3'
    curl -s --data-binary @long.wav 'http://127.0.0.1:8000/transcribe?long=1'
    curl -s -X POST http://127.0.0.1:8000/reload
    curl -s http://127.0.0.1:8000/stats

Port of ``ss_asr_tpu/cli/serve.py``: the same arguments, less
``--pallas-kernel`` (the device decides the route) and plus ``--device``
(default ``cuda``; a missing GPU is an error).  The beam width and LM
weight follow the config (``conf/default.yaml``: beam 3, LM weight 0.5)
unless ``--beam`` / ``--lm-weight`` say otherwise; ``POST /reload``
re-reads the checkpoint paths given here.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ss_asr_tpu_torch.serve")
    parser.add_argument("checkpoint", help="ASR checkpoint (.npz, JAX tree layout)")
    parser.add_argument("--config", default=None,
                        help="experiment yaml (asr.mdl sizes, decode params, char_lm.mdl); "
                             "omit for the flagship defaults")
    parser.add_argument("--lm", default=None, help="char-LM checkpoint for shallow fusion")
    parser.add_argument("--beam", type=int, default=None,
                        help="beam size (default: config decode_beam_size, else greedy)")
    parser.add_argument("--lm-weight", type=float, default=None)
    parser.add_argument("--max-steps", type=int, default=200)
    parser.add_argument("--sr", type=int, default=22050,
                        help="frontend sample rate (wavs are resampled)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-batch", type=int, default=16)
    parser.add_argument("--max-wait-ms", type=float, default=5.0,
                        help="batching window: how long the first request in a batch "
                             "waits for company")
    parser.add_argument("--mode", choices=["signal", "fbank"], default="signal",
                        help="signal: waveforms batch through frontend + decode; "
                             "fbank: per-request frontend, decode-only batching")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default cuda)")
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
    from ss_asr_tpu_torch.serve import BatchingTranscriber, serve_http

    kw = {"max_steps": args.max_steps, "sr": args.sr}
    if args.beam is not None:
        kw["beam_size"] = args.beam
    if args.lm_weight is not None:
        kw["lm_weight"] = args.lm_weight
    t = Transcriber.from_checkpoint(args.checkpoint, config=config,
                                    lm_path=args.lm, device=args.device, **kw)
    with BatchingTranscriber(t, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                             mode=args.mode, sr=args.sr) as bt:
        print(f"serving on http://{args.host}:{args.port} (max_batch={args.max_batch}, "
              f"window={args.max_wait_ms}ms, mode={args.mode}, device={args.device})",
              flush=True)
        serve_http(bt, host=args.host, port=args.port, sr=args.sr,
                   reload_paths={"asr": args.checkpoint, "lm": args.lm})


if __name__ == "__main__":
    main()
