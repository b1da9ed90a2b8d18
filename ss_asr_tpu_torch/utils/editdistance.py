"""Edit (Levenshtein) distance.

The pure-Python half of ``ss_asr_tpu/utils/editdistance.py`` (whose native
C kernel is the JAX package's own build and is not ported).
"""

from __future__ import annotations

from typing import Hashable, Sequence


def edit_distance(a: Sequence[Hashable], b: Sequence[Hashable]) -> int:
    """Levenshtein distance between two token sequences (words or chars)."""
    a, b = list(a), list(b)
    row = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        prev, row = row, [i] + [0] * len(b)
        for j, y in enumerate(b, 1):
            row[j] = min(prev[j] + 1, row[j - 1] + 1, prev[j - 1] + (x != y))
    return row[-1]
