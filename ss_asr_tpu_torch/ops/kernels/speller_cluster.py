"""What the speller kernels' cluster routes share (K6 / K7 in
``csrc/greedy_decode.cu``, K9 in ``csrc/spell_fwd.cu``, K10 in
``csrc/spell_bwd.cu``): the CTA's shape, the speller shapes a cluster can
split, and the choice of tile height from the batch.  ``decode.py`` and
``spell.py`` build their shared-memory plans and routes from these and
from ``lstm.py``'s ``CARD_CLUSTERS`` and ``SMEM_BYTES``."""

from __future__ import annotations

from typing import Sequence

from ss_asr_tpu_torch.ops.kernels.lstm import CARD_CLUSTERS

#: the cluster route's CTA: threads, warps, and the units and gate columns it
#: owns (``kSpThreads``, ``kSpUnits`` in ``csrc/speller.cuh``)
SP_THREADS = 512
SP_WARPS = SP_THREADS // 32
SP_UNITS = 32
SP_COLS = 4 * SP_UNITS


def r4(n: int) -> int:
    """``n`` floats rounded up to whole float4s (the plans' ``round4``)."""
    return (n + 3) // 4 * 4


def cluster_shape_serves(H: int, F: int, M: int, S: int, V: int) -> bool:
    """Whether the speller kernels' cluster routes can split this shape:
    C = H / 32 CTAs, at most 8 (a portable cluster); the context's F and the
    query's M columns split evenly over the CTAs in float4s; at most 512
    logits (one a thread)."""
    C = H // 32
    return (H % 32 == 0 and C in (1, 2, 4, 8) and F % (4 * C) == 0 and F // C <= SP_THREADS
            and M % (4 * C) == 0 and M // C <= SP_THREADS and 1 <= V <= SP_THREADS and S >= 1)


def tile_route(B: int, H: int, serving: Sequence[int]) -> int:
    """Of the tile heights ``serving`` (ascending), the smallest whose
    clusters of H / 32 CTAs are all resident at once on the card, else the
    largest; 0 where none serves."""
    if not serving:
        return 0
    fit = [R for R in serving if -(-B // R) <= CARD_CLUSTERS[H // 32]]
    return fit[0] if fit else serving[-1]
