"""Synthetic tone-speech corpus generator.

Copied from ``ss_asr_tpu/cli/mkdata.py`` (numpy and the standard library
only): the same bytes for the same ``--seed``.

Creates wav+txt pairs where every character is rendered as a distinct pure
tone, so the audio->text mapping is exactly learnable.  Useful for smoke
tests, demos, and verifying an installation end-to-end without a real
corpus:

    python -m ss_asr_tpu_torch.cli.mkdata out_dir --n 64 --seed 0
    python -m ss_asr_tpu_torch.cli.preprocess generic out_dir/processed out_dir/wav out_dir/txt --sr 8000
"""

from __future__ import annotations

import argparse
import os
import wave

import numpy as np

SR = 8000
CHAR_MS = 160
#: distinct, well-separated tone frequencies per character
FREQS = {c: 300.0 + 150.0 * i for i, c in enumerate("abcdefghij ")}
WORDS = ["aba", "bead", "cafe", "dig", "echo", "fig", "gab", "hide", "ice", "jade"]

#: larger inventory over the same tone alphabet — the quality protocol's
#: mid-error mixed regime needs enough lexical variety that an LM-weight
#: sweep has gradient signal instead of collapsing onto a handful of flips
WORDS_LARGE = WORDS + [
    "bad", "cab", "dice", "edge", "face", "gag", "head", "idea", "jig",
    "ache", "badge", "cage", "dead", "ebb", "fade", "gibe", "hedge",
    "beef", "chid", "dab", "egad", "fib", "gad", "hag", "iced", "jab",
    "bide", "chafe", "deed", "fiche",
]

#: acoustic homophones: these characters render as ANOTHER character's tone,
#: making them indistinguishable from audio alone — only a language model can
#: pick the right spelling (the thesis' beam+LM selling point, Table 6.12,
#: reproduced synthetically)
HOMOPHONES = {"i": "e", "g": "c"}

# ---------------------------------------------------------------------------
# hard mode: synthetic speech with real-speech-like nuisance variation
# ---------------------------------------------------------------------------
#
# The pure-tone corpus above is exactly learnable — a model that memorizes
# eleven stationary frequencies saturates it, so held-out WER hits a floor
# and robustness features (SpecAugment, SAE pretraining on varied audio)
# have nothing to pay for.  ``render_hard`` keeps the same character
# alphabet and lexicon but makes the acoustics behave like speech:
#
#   * each character is a two-formant pair on a deliberately CROWDED grid
#     (F1 spacing 70 Hz, interleaved F2), so neighboring characters'
#     spectra overlap once speakers shift them;
#   * every utterance draws a speaker: global pitch factor (±~16%), an
#     independent second-formant shift, and a vibrato rate/depth — the
#     same character lands on different absolute frequencies per speaker
#     (what forces the model to learn relative, not absolute, cues);
#   * per-character duration jitter (0.6-1.45x) breaks fixed alignment;
#   * additive white noise at a per-utterance SNR swept over
#     ``HARD_SNR_DB`` (default 8-25 dB);
#   * raised-cosine attack/decay envelopes + vibrato make every frame
#     non-stationary (a reconstruction target the SAE can't trivially
#     memorize).
#
# Used by the quality campaign (benchmarks/malromur_parity.py
# ``compare --hard``) to give WER headroom; see docs/GAIN_*.json.

HARD_CHAR_MS = 140
HARD_ALPHABET = "abcdefghij"
HARD_SNR_DB = (8.0, 25.0)


def _hard_formants(ch: str) -> tuple:
    """(F1, F2) for a character: F1 on a crowded 70 Hz grid, F2 interleaved
    so characters adjacent in F1 differ in F2 (and vice versa) — separable
    in the clean case, overlapping under speaker shift + noise."""
    i = HARD_ALPHABET.index(ch) if ch in HARD_ALPHABET else len(HARD_ALPHABET)
    f1 = 350.0 + 70.0 * i
    f2 = 900.0 + 110.0 * ((3 * i) % 11)
    return f1, f2


def hard_speaker(rng) -> dict:
    """Draw a per-utterance speaker: pitch/formant shifts + vibrato + SNR."""
    return {
        "pitch": float(np.exp(rng.uniform(np.log(0.85), np.log(1.18)))),
        "f2_shift": float(rng.uniform(0.92, 1.08)),
        "vib_hz": float(rng.uniform(4.5, 7.0)),
        "vib_depth": float(rng.uniform(0.01, 0.03)),
        "snr_db": float(rng.uniform(*HARD_SNR_DB)),
    }


def render_hard(text: str, rng, homophones: bool = False,
                speaker: dict | None = None) -> np.ndarray:
    """Synthetic hard-speech rendering of ``text`` (see module block above).

    ``homophones`` composes with hard mode: the mapped characters borrow the
    target character's FORMANTS (i->e, g->c) so only text knowledge can pick
    the spelling, exactly as in tone mode."""
    spk = speaker if speaker is not None else hard_speaker(rng)
    if homophones:
        text = "".join(HOMOPHONES.get(ch, ch) for ch in text)
    pieces = []
    for ch in text:
        dur_s = HARD_CHAR_MS / 1000.0 * float(rng.uniform(0.6, 1.45))
        n = max(int(SR * dur_s), 16)
        if ch == " ":
            pieces.append(np.zeros(n, np.float32))
            continue
        t = np.arange(n) / SR
        f1, f2 = _hard_formants(ch)
        f1 *= spk["pitch"]
        f2 *= spk["pitch"] * spk["f2_shift"]
        # vibrato as true FM: integrate the instantaneous-rate modulation
        vib = 1.0 + spk["vib_depth"] * np.sin(
            2 * np.pi * spk["vib_hz"] * t + float(rng.uniform(0, 2 * np.pi)))
        phase = 2 * np.pi * np.cumsum(vib) / SR
        amp = float(rng.uniform(0.7, 1.0))
        seg = amp * (np.sin(f1 * phase) + 0.6 * np.sin(f2 * phase))
        # 8 ms raised-cosine attack/decay: no clicks, every frame transient
        r = min(int(0.008 * SR), n // 2)
        if r > 0:
            ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(r) / r)
            seg[:r] *= ramp
            seg[-r:] *= ramp[::-1]
        pieces.append(seg.astype(np.float32))
    y = 0.5 * np.concatenate(pieces).astype(np.float32)
    p_sig = float(np.mean(np.square(y)))
    p_noise = max(p_sig, 1e-8) / (10.0 ** (spk["snr_db"] / 10.0))
    return y + np.sqrt(p_noise) * rng.standard_normal(len(y)).astype(np.float32)


def render(text: str, rng, homophones: bool = False) -> np.ndarray:
    n = int(SR * CHAR_MS / 1000)
    t = np.arange(n) / SR
    if homophones:
        text = "".join(HOMOPHONES.get(ch, ch) for ch in text)
    sig = [np.sin(2 * np.pi * FREQS.get(ch, 2000.0) * t) for ch in text]
    y = np.concatenate(sig).astype(np.float32)
    return y + 0.01 * rng.standard_normal(len(y)).astype(np.float32)


def write_wav(path: str, y: np.ndarray, sr: int = SR) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(y, -1, 1) * 32767).astype(np.int16).tobytes())


def make_corpus(out_dir: str, n: int = 64, seed: int = 0, max_words: int = 3,
                homophones: bool = False, words=None,
                hard: bool = False) -> None:
    rng = np.random.default_rng(seed)
    vocab = list(words) if words is not None else WORDS
    renderer = render_hard if hard else render
    wav_dir = os.path.join(out_dir, "wav")
    txt_dir = os.path.join(out_dir, "txt")
    os.makedirs(wav_dir, exist_ok=True)
    os.makedirs(txt_dir, exist_ok=True)
    for i in range(n):
        k = int(rng.integers(1, max_words + 1))
        text = " ".join(rng.choice(vocab) for _ in range(k))
        write_wav(
            os.path.join(wav_dir, f"u{i:04d}.wav"),
            renderer(text, rng, homophones=homophones),
        )
        with open(os.path.join(txt_dir, f"u{i:04d}.txt"), "w", encoding="utf-8") as f:
            f.write(text)
    print(f"wrote {n} synthetic utterances under {out_dir}/(wav|txt)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ss_asr_tpu_torch.mkdata")
    ap.add_argument("out_dir")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-words", type=int, default=3)
    ap.add_argument("--homophones", action="store_true",
                    help="render i/g as e/c tones (LM-only disambiguation)")
    ap.add_argument("--hard", action="store_true",
                    help="hard synthetic speech: crowded formant pairs, "
                         "speaker pitch/formant shifts, vibrato, duration "
                         "jitter, swept-SNR noise (see render_hard)")
    args = ap.parse_args(argv)
    make_corpus(args.out_dir, args.n, args.seed, args.max_words,
                args.homophones, hard=args.hard)


if __name__ == "__main__":
    main()
