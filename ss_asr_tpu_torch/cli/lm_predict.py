"""Char-LM teacher-forcing sweep CLI, on a GPU.

    python -m ss_asr_tpu_torch.cli.lm_predict --config C --text "some sentence" \
        [--name N] [--device cuda]

Port of ``ss_asr_tpu/cli/lm_predict.py``: the same options, plus
``--device`` (default ``cuda``; a missing GPU is an error).  Prints the
normalised probe text without its first character, then for tf_rate 0.0,
0.1, ..., 1.0 the LM's next-character accuracy on it
(``CHARLMTrainer.predict``).
"""

from __future__ import annotations

import argparse

from ss_asr_tpu_torch.cli.generate import add_common_args, lm_trainer


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ss_asr_tpu_torch.lm_predict")
    add_common_args(parser)
    parser.add_argument("--text", type=str, required=True)
    args = parser.parse_args(argv)

    from ss_asr_tpu_torch.vocab import normalize_string

    trainer = lm_trainer(args)
    text, _ = normalize_string(args.text, append_tokens=False)
    x, y = text[:-1], text[1:]
    print(y)
    for t in [0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1]:
        acc = trainer.predict(x, y, t)
        print(f"tf_rate={t}: {acc:.1f}%")


if __name__ == "__main__":
    main()
