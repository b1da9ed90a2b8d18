"""Character vocabulary and id -> text mapping.

Copied from ``ss_asr_tpu/vocab.py`` (the subset the serving path needs):
the fixed 50-symbol inventory, ``SOS_ID=0`` (also the pad id),
``EOS_ID=1``, and ``Mapper.translate``, which cuts after the first EOS and
drops SOS/EOS.
"""

from __future__ import annotations

from typing import List, Sequence

CHARS = "abcdefghijklmnoprstuvxy0123456789"
ICE_CHARS = "áéíóúýæöþð"
SPECIAL_CHARS = " .,?"
ALL_CHARS = CHARS + ICE_CHARS + SPECIAL_CHARS

SOS_TKN = "<"
EOS_TKN = ">"
UNK_TKN = "$"
TOKENS = SOS_TKN + EOS_TKN + UNK_TKN

#: Full vocabulary string; position == integer id.
VOCAB = TOKENS + ALL_CHARS

SOS_ID = 0
EOS_ID = 1

VOCAB_SIZE = len(VOCAB)


def trim_eos(sequence: Sequence[int]) -> List[int]:
    """Keep ids up to and including the first EOS (id 1)."""
    out: List[int] = []
    for char in sequence:
        out.append(int(char))
        if int(char) == EOS_ID:
            break
    return out


class Mapper:
    """Index -> character mapping over the fixed vocabulary."""

    def __init__(self, tokens: str = VOCAB):
        self.r_mapping = dict(enumerate(tokens))

    def translate(self, seq: Sequence[int]) -> str:
        """Id sequence -> human string: cut after first EOS, drop SOS/EOS."""
        out = [self.r_mapping[c] for c in trim_eos(seq)]
        return "".join(out).replace(SOS_TKN, "").replace(EOS_TKN, "")
