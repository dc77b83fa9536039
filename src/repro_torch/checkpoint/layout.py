"""Shard → contiguous-run decomposition.

scda assumes contiguous indexed partitions of the element stream (paper §1:
"we assume nothing but a contiguous indexed partition").  A tensor sharded
over a multi-axis device mesh gives each device a rectangular block that is
generally *not* contiguous in the canonical row-major byte stream; it is,
however, a union of contiguous runs.  We decompose every shard into its runs
and write/read each run as a window of the leaf's A section — the file bytes
stay canonical row-major, hence partition-independent, while every device
performs only positioned I/O on its own data (the paper's `indirect`
addressing, generalized from "list of element pointers" to "list of element
ranges").
"""
from __future__ import annotations

import itertools
import math
from typing import List, Sequence, Tuple

#: (global_byte_offset, local_byte_offset, byte_length)
Run = Tuple[int, int, int]


def _normalize(global_shape: Sequence[int], index) -> Tuple[List[int], List[int]]:
    """Resolve a tuple-of-slices shard index → (starts, extents)."""
    starts, extents = [], []
    for dim, sl in zip(global_shape, index):
        if isinstance(sl, slice):
            start, stop, step = sl.indices(dim)
            if step != 1:
                raise ValueError("strided shard slices are unsupported")
        else:  # integer index (should not occur for jax shards)
            start, stop = int(sl), int(sl) + 1
        starts.append(start)
        extents.append(max(0, stop - start))
    return starts, extents


def shard_runs(global_shape: Sequence[int], index,
               itemsize: int) -> List[Run]:
    """Contiguous row-major runs of the shard ``index`` of a global tensor.

    Returns runs ordered by local (shard-buffer) offset, which for
    rectangular blocks is also global-offset order.
    """
    global_shape = list(global_shape)
    nd = len(global_shape)
    if nd == 0:  # scalar
        return [(0, 0, itemsize)]
    if index is None or len(index) == 0:
        index = tuple(slice(0, d) for d in global_shape)
    starts, extents = _normalize(global_shape, index)
    if any(e == 0 for e in extents) or any(d == 0 for d in global_shape):
        return []
    # Largest full suffix: dims j > k with the shard spanning the whole dim.
    k = nd - 1
    while k >= 0 and starts[k] == 0 and extents[k] == global_shape[k]:
        k -= 1
    if k < 0:  # shard is the whole tensor
        return [(0, 0, math.prod(global_shape) * itemsize)]
    # One run covers dim k's extent times all trailing (full) dims.
    trailing = math.prod(global_shape[k + 1:])
    run_bytes = extents[k] * trailing * itemsize
    # Global row-major element strides.
    strides = [0] * nd
    acc = 1
    for j in range(nd - 1, -1, -1):
        strides[j] = acc
        acc *= global_shape[j]
    runs: List[Run] = []
    local = 0
    for multi in itertools.product(*(range(e) for e in extents[:k])):
        gelem = sum((starts[j] + multi[j]) * strides[j] for j in range(k))
        gelem += starts[k] * strides[k]
        runs.append((gelem * itemsize, local, run_bytes))
        local += run_bytes
    return runs


def runs_cover_exactly(runs_by_owner: Sequence[Sequence[Run]],
                       total_bytes: int) -> bool:
    """Check that the union of all owners' runs tiles [0, total) exactly once.

    Used as a saver-side invariant: after replica deduplication, every byte
    of the canonical stream must have exactly one writer.
    """
    spans = sorted((g, g + n) for owner in runs_by_owner
                   for (g, _, n) in owner)
    pos = 0
    for a, b in spans:
        if a != pos:
            return False
        pos = b
    return pos == total_bytes


def chunks_for_runs(runs: Sequence[Run], chunk_bytes: int) -> List[int]:
    """Sorted indices of the chunks overlapping any of ``runs``.

    The selective-restore primitive for compressed leaves: a shard reads
    (and inflates) only these chunk elements of the leaf's varray, never
    the rest of the archive.
    """
    needed = set()
    for g, _, n in runs:
        if n:
            needed.update(range(g // chunk_bytes,
                                (g + n - 1) // chunk_bytes + 1))
    return sorted(needed)


def chunk_sizes(nbytes: int, chunk_bytes: int) -> List[int]:
    """Deterministic chunking of a leaf's byte stream for §3 compression.

    Sizes depend only on (nbytes, chunk_bytes) — both recorded in the
    manifest — so compressed checkpoints remain partition-independent.
    """
    if nbytes == 0:
        return []
    full, rem = divmod(nbytes, chunk_bytes)
    return [chunk_bytes] * full + ([rem] if rem else [])
