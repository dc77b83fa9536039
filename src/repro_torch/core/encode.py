"""Serial (in-memory) section encoders — the byte oracle for the format.

These functions produce the complete on-disk bytes of each section from the
*global* data.  They define serial-equivalence: the parallel writer must
produce byte-identical output for any partition.  Tests compare the parallel
writer against these oracles, and the parallel writer itself reuses them for
rank-0-owned metadata.

Each section also has an ``iov_*`` variant returning the section as a
scatter-gather list (iovec) of buffers in file order, with payload buffers
passed through by reference — zero copies.  ``encode_* = join(iov_*)``.
The parallel writer hands ``iov_inline``/``iov_block`` fragment lists
straight to ``FileBackend.pwritev`` for its root-owned sections (one
syscall, payload never concatenated); for the partitioned A/V sections it
assembles per-rank ``(offset, buffer)`` fragments from the same spec
primitives, since each rank owns only a slice of the section.  Varray
count entries are generated vectorized
(:func:`repro.core.spec.count_entries`) instead of one Python call per
element.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.core import spec
from repro_torch.core.errors import ScdaError, ScdaErrorCode
from repro_torch.core.io_backend import BytesLike


def iov_inline(user_string: bytes, data: BytesLike,
               style: str = spec.UNIX) -> List[BytesLike]:
    """Inline section I (paper §2.3, Fig. 2): exactly 32 unpadded data bytes."""
    if len(data) != spec.INLINE_DATA_BYTES:
        raise ScdaError(ScdaErrorCode.ARG_INLINE_SIZE, f"{len(data)} bytes")
    return [spec.section_header(b"I", user_string, style), data]


def iov_block(user_string: bytes, data: BytesLike,
              style: str = spec.UNIX) -> List[BytesLike]:
    """Block section B (paper §2.4, Fig. 3)."""
    E = len(data)
    last = memoryview(data)[-1] if E else None
    return [spec.section_header(b"B", user_string, style),
            spec.count_entry(b"E", E, style),
            data,
            spec.pad_data(E, last, style)]


def iov_array(user_string: bytes, data: BytesLike, N: int, E: int,
              style: str = spec.UNIX) -> List[BytesLike]:
    """Fixed-size array section A (paper §2.5, Fig. 4)."""
    if len(data) != N * E:
        raise ScdaError(ScdaErrorCode.ARG_DATA_SIZE,
                        f"{len(data)} bytes != N*E = {N * E}")
    n = N * E
    last = memoryview(data)[-1] if n else None
    return [spec.section_header(b"A", user_string, style),
            spec.count_entry(b"N", N, style),
            spec.count_entry(b"E", E, style),
            data,
            spec.pad_data(n, last, style)]


def iov_varray(user_string: bytes, elements: Sequence[BytesLike],
               style: str = spec.UNIX) -> List[BytesLike]:
    """Variable-size array section V (paper §2.6, Fig. 5).

    The N per-element 'E' entries are emitted as ONE buffer (vectorized
    generation); element payloads are passed through by reference.
    """
    N = len(elements)
    sizes = list(map(len, elements))
    parts: List[BytesLike] = [spec.section_header(b"V", user_string, style),
                              spec.count_entry(b"N", N, style),
                              spec.count_entries(b"E", sizes, style,
                                                 trusted_ints=True)]
    payload = list(filter(len, elements))
    parts += payload
    last = memoryview(payload[-1])[-1] if payload else None
    parts.append(spec.pad_data(sum(sizes), last, style))
    return parts


def _join(parts: Sequence[BytesLike]) -> bytes:
    return b"".join(parts)  # bytes.join accepts any buffer objects


def encode_inline(user_string: bytes, data: bytes,
                  style: str = spec.UNIX) -> bytes:
    out = _join(iov_inline(user_string, data, style))
    assert len(out) == spec.INLINE_SECTION_BYTES
    return out


def encode_block(user_string: bytes, data: bytes,
                 style: str = spec.UNIX) -> bytes:
    out = _join(iov_block(user_string, data, style))
    assert len(out) == spec.block_section_bytes(len(data))
    return out


def encode_array(user_string: bytes, data: bytes, N: int, E: int,
                 style: str = spec.UNIX) -> bytes:
    out = _join(iov_array(user_string, data, N, E, style))
    assert len(out) == spec.array_section_bytes(N, E)
    return out


def encode_varray(user_string: bytes, elements: Sequence[bytes],
                  style: str = spec.UNIX) -> bytes:
    out = _join(iov_varray(user_string, elements, style))
    assert len(out) == spec.varray_section_bytes(
        len(elements), sum(map(len, elements)))
    return out


def encode_file(vendor: bytes, user_string: bytes, sections: Sequence[bytes],
                style: str = spec.UNIX) -> bytes:
    """A complete file: header F followed by pre-encoded sections, no gaps."""
    return spec.file_header(vendor, user_string, style) + b"".join(sections)
