"""Partition arithmetic for parallel array I/O (paper §A.1).

A partition of N global elements over P ranks is the vector (N_q)_{<P} of
per-rank counts with offsets C_p = Σ_{q<p} N_q, C_0 = 0, C_P = N (eq. 11).
For variable element sizes (E_i)_{<N}, per-rank byte counts are
S_p = Σ_{C_p ≤ i < C_{p+1}} E_i (eq. 12); fixed size E gives S_p = N_p·E
(eq. 13).

The fundamental assumption (paper §A.1): each element is owned by exactly
one rank and ownership is monotone by rank — i.e. contiguous index ranges.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.core.errors import ScdaError, ScdaErrorCode


def offsets(counts: Sequence[int]) -> List[int]:
    """Exclusive prefix sums (C_q)_{≤P}: offsets[p] = C_p, offsets[P] = N."""
    out = [0]
    for c in counts:
        if c < 0:
            raise ScdaError(ScdaErrorCode.ARG_PARTITION, f"negative count {c}")
        out.append(out[-1] + c)
    return out


def validate(counts: Sequence[int], N: int) -> None:
    """Check Σ N_q == N (paper §A.5: 'must satisfy')."""
    total = sum(counts)
    if total != N:
        raise ScdaError(ScdaErrorCode.ARG_PARTITION,
                        f"partition sums to {total}, expected {N}")
    if any(c < 0 for c in counts):
        raise ScdaError(ScdaErrorCode.ARG_PARTITION, "negative count")


def uniform(N: int, P: int) -> List[int]:
    """The canonical balanced partition: ⌈N/P⌉ for the first N mod P ranks."""
    base, rem = divmod(N, P)
    return [base + (1 if p < rem else 0) for p in range(P)]


def byte_range(counts: Sequence[int], E: int, rank: int) -> Tuple[int, int]:
    """(byte offset, byte length) of ``rank``'s slice of a fixed-size array."""
    offs = offsets(counts)
    return offs[rank] * E, counts[rank] * E


def var_byte_ranges(counts: Sequence[int],
                    local_sizes: Sequence[int],
                    per_rank_bytes: Sequence[int],
                    rank: int) -> Tuple[int, int]:
    """(byte offset, byte length) of ``rank``'s slice of a varray.

    ``per_rank_bytes`` is (S_q)_{<P} — collective, as in the paper's
    ``scda_fwrite_varray`` signature ("we leave eventual allgather-type
    operations to the caller").
    """
    if sum(local_sizes) != per_rank_bytes[rank]:
        raise ScdaError(ScdaErrorCode.ARG_DATA_SIZE,
                        f"local sizes sum {sum(local_sizes)} != "
                        f"S_p {per_rank_bytes[rank]}")
    start = sum(per_rank_bytes[:rank])
    return start, per_rank_bytes[rank]


def last_nonempty_rank(counts_bytes: Sequence[int]) -> int:
    """The rank owning the final data byte (writes the '=' padding), or -1."""
    for p in range(len(counts_bytes) - 1, -1, -1):
        if counts_bytes[p] > 0:
            return p
    return -1


def repartition_ranges(old_counts: Sequence[int], new_counts: Sequence[int],
                       rank: int) -> List[Tuple[int, int, int]]:
    """Overlaps of ``rank``'s new range with old ranks (for elastic restart).

    Returns [(old_rank, start_elem, n_elems), ...] covering the new range.
    Not needed for file reading (any partition reads directly) but useful for
    in-memory redistribution bookkeeping.
    """
    new_offs = offsets(new_counts)
    lo, hi = new_offs[rank], new_offs[rank + 1]
    old_offs = offsets(old_counts)
    out: List[Tuple[int, int, int]] = []
    for q in range(len(old_counts)):
        a, b = old_offs[q], old_offs[q + 1]
        s, e = max(lo, a), min(hi, b)
        if s < e:
            out.append((q, s, e - s))
    return out
