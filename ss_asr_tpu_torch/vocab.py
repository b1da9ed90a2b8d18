"""Character vocabulary and id -> text mapping.

Copied from ``ss_asr_tpu/vocab.py``: the fixed 50-symbol inventory,
``SOS_ID=0`` (also the pad id), ``EOS_ID=1``, ``UNK_ID=2``,
``normalize_string`` (raw text -> the closed inventory, for
preprocessing), ``Mapper`` (``encode`` an index's normalised text -> ids,
``decode`` ids -> text verbatim, ``translate``, which cuts after the first
EOS and drops SOS/EOS, and the one-symbol lookups) and ``encode_texts``
(a batch of texts -> padded ids and lengths).  The one-symbol lookups and
``encode_texts`` keep the JAX package's surface for its callers; no module
of this package calls them.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

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
UNK_ID = 2

VOCAB_SIZE = len(VOCAB)


_OOV_RE = re.compile(f"[^{re.escape(ALL_CHARS)}]")
_WS_RE = re.compile(r"\s+")


def normalize_string(s: str, append_tokens: bool = True) -> Tuple[str, int]:
    """Normalise raw text into the closed character inventory -> ``(text,
    s_len)``: lowercase, whitespace collapsed, out-of-inventory characters
    replaced by UNK, SOS / EOS added; ``s_len`` is the collapsed lowercase
    string's length plus 2, measured before the UNK substitution."""
    s = s.lower()
    s = _WS_RE.sub(" ", s)
    s_len = len(s) + 2
    s = _OOV_RE.sub(UNK_TKN, s)
    if append_tokens:
        s = SOS_TKN + s + EOS_TKN
    return s, s_len


def trim_eos(sequence: Sequence[int]) -> List[int]:
    """Keep ids up to and including the first EOS (id 1)."""
    out: List[int] = []
    for char in sequence:
        out.append(int(char))
        if int(char) == EOS_ID:
            break
    return out


class Mapper:
    """Character <-> index mapping over the fixed vocabulary."""

    def __init__(self, tokens: str = VOCAB):
        self.tokens = tokens
        self.mapping = {c: i for i, c in enumerate(tokens)}
        self.r_mapping = dict(enumerate(tokens))

    def char_to_ind(self, char: str) -> int:
        return self.mapping[char]

    def ind_to_char(self, ind: int) -> str:
        return self.r_mapping[int(ind)]

    def encode(self, text: str) -> np.ndarray:
        """String -> int32 id array (no implicit SOS/EOS handling)."""
        return np.array([self.mapping[c] for c in text], dtype=np.int32)

    def decode(self, ids: Sequence[int]) -> str:
        """Id sequence -> string, verbatim (no EOS trimming)."""
        return "".join(self.r_mapping[int(i)] for i in ids)

    def translate(self, seq: Sequence[int]) -> str:
        """Id sequence -> human string: cut after first EOS, drop SOS/EOS."""
        out = [self.r_mapping[c] for c in trim_eos(seq)]
        return "".join(out).replace(SOS_TKN, "").replace(EOS_TKN, "")

    def get_dim(self) -> int:
        return len(self.mapping)


def encode_texts(
    texts: Sequence[str], mapper: Mapper, pad_to: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode a batch of (normalised, SOS/EOS-wrapped) strings -> ``(ids
    [B, L] int32, lengths [B] int32)``, padded with SOS (id 0) to ``pad_to``
    or the batch's longest; a length counts the row's ids, capped at the
    padded width."""
    encoded = [mapper.encode(t) for t in texts]
    lens = np.array([e.shape[0] for e in encoded], dtype=np.int32)
    max_len = int(pad_to) if pad_to is not None else int(lens.max())
    out = np.full((len(texts), max_len), SOS_ID, dtype=np.int32)
    for i, e in enumerate(encoded):
        out[i, : e.shape[0]] = e[:max_len]
    return out, np.minimum(lens, max_len)
