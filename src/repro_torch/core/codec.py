"""Per-element transparent compression convention (paper §3).

Two-stage algorithm (§3.1), applied to a block's data or to each array
element independently:

  stage 1:  8-byte big-endian uncompressed size ‖ b'z' ‖ RFC1950/1951
            deflate stream (any legal level; we default to zlib level 9,
            the paper's recommendation of "zlib's best compression").
  stage 2:  base64, broken into lines of 76 code bytes + a 2-byte break
            ("=\n" Unix, "\r\n" MIME), including after the final short line.

On reading, the length is known from file context; base64-decode, read the
size from the first 8 bytes, check the 'z' tag at byte 9, inflate, and verify
the three redundant checks (§3.1): the adler32 inside zlib, the size match,
and the 'z' marker.

Convention magic user strings (§3.2–3.4), version (00)₁₆:
  block        : I("B compressed scda 00", U-entry) ; B(user, compressed)
  fixed array  : I("A compressed scda 00", U-entry) ; V(user, N, compressed…)
  var. array   : A("V compressed scda 00", N, 32, U-entries) ; V(user, N, …)

Fast-path implementation (byte-identical to the reference algorithm):

* compress/decompress run zlib via streaming ``compressobj`` /
  ``decompressobj`` in bounded chunks and accept any buffer view (no
  up-front ``bytes()`` copy of the payload);
* stage-2 line breaking / unbreaking is vectorized with a numpy reshape
  instead of a Python loop over 76-byte lines;
* :func:`compress_elements` fans independent elements out over a thread
  pool (zlib releases the GIL) once the payload is large enough;
  ``REPRO_CODEC_THREADS`` tunes the width, ``1`` disables.
* The read side mirrors it: :func:`decompress_elements` inflates a batch
  of independent streams over the same pool, and
  :func:`submit_decompress_batch` hands a slice of streams to the pool as
  one future so the overlapped restore engine
  (:mod:`repro.core.pipeline`) can inflate chunk k while chunk k+1 is
  still in flight from disk.
* The write side mirrors the mirror: :func:`submit_compress_batch`
  deflates a slice of payloads as one pool job (stage 1 only — pure
  zlib, GIL released for the whole call) and the caller finishes with
  :func:`encode_stage2` (base64 + line breaks, brief GIL-held numpy) on
  its own thread, so the overlapped save engine can deflate leaf k+1
  while leaf k's ``pwritev`` is in flight.
"""
from __future__ import annotations

import base64
import binascii
import os as _os
import struct
import threading as _threading
import zlib
from typing import List, Optional, Sequence, Union

try:
    import numpy as _np
except ImportError:  # pragma: no cover - numpy is a hard dep elsewhere
    _np = None

from repro_torch.core import spec
from repro_torch.core import trace as _trace
from repro_torch.core.errors import ScdaError, ScdaErrorCode

BytesLike = Union[bytes, bytearray, memoryview]

#: Magic user strings identifying the compression convention (§3.2).
MAGIC_BLOCK = b"B compressed scda 00"
MAGIC_ARRAY = b"A compressed scda 00"
MAGIC_VARRAY = b"V compressed scda 00"
MAGIC_BY_TYPE = {b"B": MAGIC_BLOCK, b"A": MAGIC_ARRAY, b"V": MAGIC_VARRAY}

_B64_LINE = 76
_LINE_BREAK = {spec.UNIX: b"=\n", spec.MIME: b"\r\n"}

#: zlib level.  The paper recommends Z_BEST_COMPRESSION (9); §Perf
#: checkpoint-I/O iteration CK2 measured level 6 at 12x the deflate
#: throughput of level 9 at IDENTICAL ratio on checkpoint-like payloads
#: (level 9 burns its time on the incompressible half), so the library
#: default is 6 (REPRO_ZLIB_LEVEL overrides; 9 reproduces the paper's
#: recommendation, 0 is legal for zlib-free writers).
DEFAULT_LEVEL = int(_os.environ.get("REPRO_ZLIB_LEVEL", "6"))

#: Streaming chunk size for the compressobj/decompressobj loops.
_ZLIB_CHUNK = 1 << 20

#: Below this many encoded bytes the numpy reshape costs more than the loop.
_NP_MIN_BYTES = 1 << 10

#: Thread-pool policy for compress_elements: worth it only past real work.
_POOL_MIN_ELEMENTS = 4
_POOL_MIN_BYTES = 1 << 20
def _default_pool_width() -> int:
    return int(_os.environ.get("REPRO_CODEC_THREADS", "0")) \
        or min(8, _os.cpu_count() or 1)


_POOL_THREADS = _default_pool_width()
_pool = None
_pool_lock = _threading.Lock()


def _deflate(view: memoryview, level: int) -> List[bytes]:
    c = zlib.compressobj(level)
    parts = [c.compress(view[i:i + _ZLIB_CHUNK])
             for i in range(0, len(view), _ZLIB_CHUNK)]
    parts.append(c.flush())
    return parts


def _break_lines(encoded: bytes, style: str) -> bytes:
    """Split base64 output into 76-byte lines, each followed by the 2-byte
    break; "the same two bytes are added after the last line of encoding if
    it is short of 76 bytes" — a full final line already has its break, so
    an exact multiple of 76 ends with exactly one break."""
    brk = _LINE_BREAK[style]
    L = len(encoded)
    if L == 0:  # zero-byte stage1 cannot happen (≥ 9 bytes), but be safe
        return brk
    full, rem = divmod(L, _B64_LINE)
    if _np is None or L < _NP_MIN_BYTES:
        lines: List[bytes] = []
        for i in range(0, L, _B64_LINE):
            lines.append(encoded[i:i + _B64_LINE])
            lines.append(brk)
        return b"".join(lines)
    out = _np.empty((full, _B64_LINE + 2), _np.uint8)
    out[:, :_B64_LINE] = _np.frombuffer(
        encoded, _np.uint8, full * _B64_LINE).reshape(full, _B64_LINE)
    out[:, _B64_LINE] = brk[0]
    out[:, _B64_LINE + 1] = brk[1]
    head = out.tobytes()
    if rem:
        return head + encoded[full * _B64_LINE:] + brk
    return head


def _unbreak_lines(stream: bytes) -> bytes:
    """Strip the 2 break bytes after each ≤76-byte line (geometry only —
    the break bytes are "arbitrary" per §3.1, so their value is not
    validated)."""
    L = len(stream)
    step = _B64_LINE + 2
    nfull, rem = divmod(L, step)
    if rem == 0:
        if _np is None or L < _NP_MIN_BYTES:
            return b"".join(stream[i:i + _B64_LINE]
                            for i in range(0, L, step))
        return _np.frombuffer(stream, _np.uint8).reshape(
            nfull, step)[:, :_B64_LINE].tobytes()
    if rem < 3:  # a chunk must hold ≥ 1 code byte + 2 break bytes
        raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                        "truncated base64 line")
    tail = stream[nfull * step:L - 2]
    if nfull == 0:
        return tail
    if _np is None or L < _NP_MIN_BYTES:
        return b"".join(stream[i:i + _B64_LINE]
                        for i in range(0, nfull * step, step)) + tail
    head = _np.frombuffer(stream, _np.uint8, nfull * step).reshape(
        nfull, step)[:, :_B64_LINE].tobytes()
    return head + tail


def _fast_stage1(stream: bytes) -> Optional[bytes]:
    """One-pass stage-2 decode for streams with exact line geometry and a
    STANDARD break pair ("=\\n" or "\\r\\n") after every line.

    ``binascii.a2b_base64`` in lenient mode skips both standard break
    pairs in-stream (each falls on a 4-char quad boundary, where a
    padding or invalid byte is a no-op), so verifying the geometry up
    front — one vectorized check of the two break columns — lets us
    decode in a single pass without first copying the code bytes out.
    Returns None for anything unusual (odd geometry, exotic break bytes,
    lenient decoder complaints): the caller then runs the reference
    unbreak-then-strict-decode path, whose errors remain canonical.
    """
    L = len(stream)
    step = _B64_LINE + 2
    nfull, rem = divmod(L, step)
    if nfull == 0 or (rem != 0 and rem < 3):
        return None
    arr = _np.frombuffer(stream, _np.uint8, nfull * step).reshape(
        nfull, step)
    b0, b1 = arr[:, _B64_LINE], arr[:, _B64_LINE + 1]
    for brk in (_LINE_BREAK[spec.UNIX], _LINE_BREAK[spec.MIME]):
        if (b0 == brk[0]).all() and (b1 == brk[1]).all():
            if rem and stream[L - 2:] != brk:
                return None
            break
    else:
        return None
    try:
        # a2b_base64 takes any bytes-like buffer — no copy for the
        # zero-copy memoryviews the prefetch cache serves.
        return binascii.a2b_base64(stream)
    except (binascii.Error, ValueError):
        return None  # strict path reports the canonical error


def deflate_stage1(data: BytesLike, level: int = DEFAULT_LEVEL) -> bytes:
    """Stage 1 of §3.1: 8-byte big-endian size ‖ ``'z'`` ‖ deflate stream.

    Pure zlib after the 9-byte header — releases the GIL for the whole
    deflate, which is why :func:`submit_compress_batch` jobs run exactly
    this and nothing else."""
    view = memoryview(data)
    if view.format != "B" or view.ndim != 1:
        view = view.cast("B")
    stage1_parts = [struct.pack(">Q", len(view)) + b"z"]
    stage1_parts += _deflate(view, level)
    return b"".join(stage1_parts)


def encode_stage2(stage1: BytesLike, style: str = spec.UNIX) -> bytes:
    """Stage 2 of §3.1: base64 with 76-byte lines + 2-byte breaks."""
    encoded = base64.b64encode(stage1)
    return _break_lines(encoded, style)


def compress(data: BytesLike, style: str = spec.UNIX,
             level: int = DEFAULT_LEVEL) -> bytes:
    """Apply the two-stage §3.1 algorithm to one data item."""
    return encode_stage2(deflate_stage1(data, level), style)


def _parse_stage2(stream: bytes, fast: bool = False):
    """Stage-2 + stage-1-header decode: ``(usize, deflate_body_view)``.

    Splitting the decode from :func:`_inflate_checked` lets the
    overlapped restore engine keep pool jobs as single long
    GIL-releasing inflate calls.  ``fast`` additionally routes the
    base64 decode through :func:`_fast_stage1` (single-pass lenient
    decode, byte-identical, strict fallback) — used by the batch/pool
    entry points; ``decompress`` itself stays on the reference path,
    which is the serial oracle and the canonical error reporter.
    """
    if len(stream) < 2:
        raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                        f"stage-2 stream only {len(stream)} bytes")
    stage1 = None
    if fast and _np is not None and len(stream) >= _NP_MIN_BYTES:
        stage1 = _fast_stage1(stream)
    if stage1 is None:
        # reference path wants bytes (views arrive from the zero-copy
        # prefetch cache and would not concatenate with bytes below)
        if not isinstance(stream, bytes):
            stream = bytes(stream)
        code = _unbreak_lines(stream)
        try:
            stage1 = base64.b64decode(code, validate=True)
        except Exception as e:
            raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                            f"base64 decode failed: {e}") from e
    if len(stage1) < 9:
        raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                        f"stage-1 stream only {len(stage1)} bytes")
    head = stage1[:9]
    (usize,) = struct.unpack(">Q", head[:8])
    if head[8:9] != b"z":
        raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                        f"missing 'z' marker, got {head[8:9]!r}")
    return usize, memoryview(stage1)[9:]


def _inflate_checked(usize: int, body) -> bytes:
    """Inflate a stage-1 body and enforce the three redundant §3.1 checks
    (adler32 inside zlib, size match, 'z' already checked by the parse).
    Pure zlib — releases the GIL for the whole inflate."""
    d = zlib.decompressobj()
    try:
        parts = [d.decompress(body)]
        parts.append(d.flush())  # adler32 verified inside zlib at stream end
    except zlib.error as e:
        raise ScdaError(ScdaErrorCode.CORRUPT_CHECKSUM, str(e)) from e
    if not d.eof:
        raise ScdaError(ScdaErrorCode.CORRUPT_CHECKSUM,
                        "incomplete or truncated deflate stream")
    raw = parts[0] if not parts[1] else b"".join(parts)
    if len(raw) != usize:
        raise ScdaError(ScdaErrorCode.CORRUPT_CHECKSUM,
                        f"inflated {len(raw)} bytes, header says {usize}")
    return raw


def _inflate_canonical(usize: int, body, stream: BytesLike) -> bytes:
    """:func:`_inflate_checked`, but any failure defers to the serial
    oracle.  The fast lenient base64 decode accepts some corrupted
    streams the strict decoder rejects (``a2b_base64`` silently *skips*
    bytes outside the alphabet), so a bad stream can sail through the
    parse and only blow up at inflate — as CORRUPT_CHECKSUM, where the
    reference path reports CORRUPT_ENCODING.  Re-running ``decompress``
    on the original stream makes the serial path the sole authority on
    both the outcome and the error; the retry only ever runs on corrupt
    archives, so the happy path pays nothing.
    """
    try:
        return _inflate_checked(usize, body)
    except ScdaError:
        return decompress(stream)


def decompress(stream: bytes) -> bytes:
    """Invert :func:`compress`; enforce the three redundant checks (§3.1).

    The stage-2 stream has exact structure: zero or more chunks of 76 code
    bytes + 2 break bytes, with the final chunk allowed to be shorter
    (r code bytes + 2 break bytes, 0 < r ≤ 76).
    """
    usize, body = _parse_stage2(stream)
    return _inflate_checked(usize, body)


def _get_pool():
    global _pool
    if _pool is None:
        with _pool_lock:  # every ThreadComm rank may race the first use
            if _pool is None:
                from concurrent.futures import ThreadPoolExecutor
                _pool = ThreadPoolExecutor(max_workers=_POOL_THREADS,
                                           thread_name_prefix="scda-codec")
    return _pool


def compress_elements(elements: Sequence[BytesLike],
                      style: str = spec.UNIX,
                      level: int = DEFAULT_LEVEL) -> List[bytes]:
    """Per-element compression for array sections (§3.3/§3.4).

    Elements are independent deflate streams, so they parallelize
    perfectly; zlib releases the GIL, so a thread pool gives real
    speedup.  Small batches stay serial (pool dispatch costs more).
    """
    if (_POOL_THREADS > 1 and len(elements) >= _POOL_MIN_ELEMENTS
            and sum(map(len, elements)) >= _POOL_MIN_BYTES):
        return list(_get_pool().map(
            lambda e: compress(e, style, level), elements))
    return [compress(e, style, level) for e in elements]


def decompress_elements(streams: Sequence[BytesLike],
                        expected_sizes: Optional[Sequence[int]] = None) \
        -> List[bytes]:
    """Per-element decompression for array sections (§3.3/§3.4).

    The read mirror of :func:`compress_elements`: independent deflate
    streams inflate in parallel on the shared pool (zlib releases the
    GIL); small batches stay serial.  ``expected_sizes`` optionally
    enforces each element's uncompressed size (the U-entry check every
    serial read path performs), raising CORRUPT_CHECKSUM on mismatch.
    """
    if (_POOL_THREADS > 1 and len(streams) >= _POOL_MIN_ELEMENTS
            and sum(map(len, streams)) >= _POOL_MIN_BYTES):
        # fast decode here on the calling thread, long GIL-free inflates
        # on the pool — the split that actually scales (see
        # submit_decompress_batch)
        parsed = [_parse_stage2(s, fast=True) for s in streams]
        out = list(_get_pool().map(
            lambda t: _inflate_canonical(t[0][0], t[0][1], t[1]),
            zip(parsed, streams)))
    else:
        out = [decompress(s) for s in streams]
    if expected_sizes is not None:
        for i, (raw, expect) in enumerate(zip(out, expected_sizes)):
            if len(raw) != expect:
                raise ScdaError(ScdaErrorCode.CORRUPT_CHECKSUM,
                                f"element {i} inflated to {len(raw)}, "
                                f"U-entry says {expect}")
    return out


def submit_decompress_batch(streams: Sequence[BytesLike],
                            expected_sizes: Optional[Sequence[int]] = None):
    """Decode + inflate a batch of streams in ONE pool job; returns a
    Future resolving to the list of raw payloads.

    Work splits for GIL hygiene, measured every other way on the restore
    bench: the stage-2 decode (fast single-pass, GIL-held but brief)
    runs HERE on the submitting thread in long uninterrupted stretches,
    and the pool job is back-to-back GIL-releasing inflates.  Per-chunk
    futures, decode-in-job, and a numpy GIL-free decode all measured
    slower — worker wakeups and short GIL slices make the threads fight
    for the lock instead of overlapping.  Parse errors raise
    synchronously; inflate errors (and ``expected_sizes`` mismatches)
    surface on ``result()`` — all exactly the :class:`ScdaError` the
    serial :func:`decompress` would raise.
    """
    parsed = [_parse_stage2(s, fast=True) for s in streams]

    def _job() -> List[bytes]:
        out = []
        for j, (usize, body) in enumerate(parsed):
            raw = _inflate_canonical(usize, body, streams[j])
            if expected_sizes is not None and len(raw) != expected_sizes[j]:
                raise ScdaError(ScdaErrorCode.CORRUPT_CHECKSUM,
                                f"element inflated to {len(raw)}, "
                                f"U-entry says {expected_sizes[j]}")
            out.append(raw)
        return out

    c = _trace.collector()
    if c is not None:
        inner = _job
        nbytes = sum(map(len, streams))

        def _job() -> List[bytes]:  # noqa: F811 - traced worker-side span
            with c.span("inflate", "codec",
                        elements=len(parsed), bytes=nbytes):
                return inner()

    return _get_pool().submit(_job)


def submit_compress_batch(payloads: Sequence[BytesLike],
                          level: int = DEFAULT_LEVEL):
    """Deflate a batch of payloads in ONE pool job; returns a Future
    resolving to the list of stage-1 bodies (size header + 'z' + deflate
    stream).

    The write mirror of :func:`submit_decompress_batch`, with the same
    GIL discipline inverted: the pool job is back-to-back GIL-releasing
    deflates and nothing else; the submitting thread finishes each body
    with :func:`encode_stage2` (base64 + numpy line breaking — brief,
    GIL-held) when the future resolves, so worker wakeups never fight
    the caller for the lock.  ``encode_stage2(fut.result()[j], style)``
    is byte-identical to ``compress(payloads[j], style, level)`` by
    construction — :func:`compress` is those two calls.
    """
    views = [memoryview(p) for p in payloads]  # pin callers' buffers

    def _job() -> List[bytes]:
        return [deflate_stage1(v, level) for v in views]

    c = _trace.collector()
    if c is not None:
        inner = _job
        nbytes = sum(v.nbytes for v in views)

        def _job() -> List[bytes]:  # noqa: F811 - traced worker-side span
            with c.span("deflate", "codec",
                        elements=len(views), bytes=nbytes):
                return inner()

    return _get_pool().submit(_job)


def submit_task(fn, *args):
    """Run ``fn(*args)`` on the shared codec pool; returns the Future.

    Used by the overlapped save engine for its device→host snapshot
    lookahead (one leaf ahead — a double buffer, not a fan-out), so the
    rare non-codec job rides the existing pool instead of paying for a
    dedicated thread."""
    return _get_pool().submit(fn, *args)


def pool_width() -> int:
    """The codec pool's thread count (the engine sizes its in-flight
    inflate queue from this)."""
    return _POOL_THREADS


def set_pool_width(n: Optional[int]) -> int:
    """Override the pool-dispatch width at runtime; returns the previous
    value.  ``None`` re-reads ``REPRO_CODEC_THREADS``/cpu count.

    Bench/test hook (the runtime twin of the env knob): ``1`` makes
    every ``*_elements`` call run inline on the caller — the fully
    serial codec the save/restore benchmarks use as their baseline.  An
    already-created pool keeps its workers; only dispatch policy
    changes.
    """
    global _POOL_THREADS
    prev = _POOL_THREADS
    if n is None:
        n = _default_pool_width()
    _POOL_THREADS = max(1, int(n))
    return prev


def uncompressed_size_entry(u: int, style: str = spec.UNIX) -> bytes:
    """The 32-byte 'U' entry of Fig. 6 / Fig. 7."""
    return spec.count_entry(b"U", u, style)


def parse_uncompressed_size_entry(entry: bytes) -> int:
    return spec.parse_count_entry(entry, b"U")
