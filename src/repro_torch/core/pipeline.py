"""Overlapped restore and save engines — the asynchronous read and write
pipelines over the PR-1 scatter-gather fast path.

The serial restore walk is pread → inflate → copy, one chunk at a time:
the disk idles while zlib runs and zlib idles while the disk seeks.  This
module overlaps the three stages:

* upcoming extents are handed to :meth:`FileBackend.prefetch`, a small
  background executor that double-buffers them into a bounded cache
  (``REPRO_SCDA_PREFETCH`` bytes; ``0`` disables and every caller falls
  back to the exact serial order);
* the foreground thread consumes extents via :meth:`FileBackend.
  read_scatter` (coalesced ``preadv``, served from the prefetch cache
  when warm) and immediately submits compressed chunks to the shared
  ``scda-codec`` pool (:func:`repro.core.codec.submit_decompress_batch`),
  so chunk k inflates while chunk k+1 is in flight from disk;
* fully consumed extents are released back to the kernel
  (:meth:`FileBackend.release` → ``posix_fadvise(DONTNEED)``) so a long
  restore never grows the page cache beyond the prefetch window.

Byte-identity is structural: the pipeline changes WHEN bytes are read and
WHERE they inflate, never WHAT is returned — every result equals the
forward-walk read, and any failure (truncated extent, corrupt chunk)
raises the same :class:`ScdaError` the serial path would, with all
in-flight futures drained first (no leaks, no hangs).

The write half (:func:`run_write_pipeline`) is the mirror.  The serial
save walk is snapshot → deflate → pwrite, one leaf at a time: the codec
pool idles while the disk writes and the disk idles while zlib runs.
The engine overlaps the three stages —

* device→host snapshots run one item ahead on the shared pool (a double
  buffer, :func:`repro.core.codec.submit_task`), so leaf k+1 is on the
  host before leaf k finishes writing;
* compressed payloads deflate on the codec pool
  (:func:`repro.core.codec.submit_compress_batch` — deflate-only jobs,
  the write inverse of the inflate-only GIL discipline; stage-2 base64
  runs on this thread), bounded by in-flight bytes;
* finished fragments queue on :meth:`FileBackend.submit_write_gather`, a
  small writeback executor with a bounded in-flight window
  (``REPRO_SCDA_WRITE_PIPELINE`` bytes; ``0`` = the exact legacy serial
  order), and :meth:`FileBackend.drain_writes` is the completion drain.

Because serial equivalence fixes every section's extent from collective
parameters, item k+1's offsets need only item k's *planned* sizes, never
its completed write — ``plan`` callbacks run strictly in item order
while deflate and writeback float free.  Byte-identity is structural
here too: the pipeline changes WHEN payloads deflate and WHERE the
pwritev happens, never WHAT lands in the file, and any failure raises
the same :class:`ScdaError` as the serial path with every in-flight
future drained (no leaks, no hangs).

Consumers: :meth:`repro.core.reader.ScdaReader.read_batch` (batched
element reads) and the checkpoint restore/save schedulers in
:mod:`repro.checkpoint.pytree_io`.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Iterator, List, Optional, Sequence,
                    Tuple)

from repro_torch.core import codec, spec
from repro_torch.core import faults as _faults
from repro_torch.core import trace as _trace
from repro_torch.core.errors import ScdaError, ScdaErrorCode
from repro_torch.core.io_backend import BytesLike, FileBackend

#: (absolute file offset, byte length)
Extent = Tuple[int, int]


@dataclasses.dataclass
class ReadItem:
    """One schedulable unit of the pipeline (a leaf, a shard, a request).

    ``extents`` must be offset-sorted within the item, and callers should
    sort items by their first extent so consumption sweeps the file front
    to back (prefetch and ``release`` both assume forward progress).

    ``dst`` optionally supplies one writable buffer per extent — the raw
    leaf fast path, where payload bytes land directly in the shard buffer
    with zero copies.  Without it the engine allocates.  ``inflate`` runs
    each extent through §3 decompression (on the codec pool when the
    pipeline is live, inline when serial); ``expected_sizes`` then
    enforces per-extent uncompressed sizes, CORRUPT_CHECKSUM on mismatch.
    """
    key: Any
    extents: List[Extent]
    inflate: bool = False
    expected_sizes: Optional[Sequence[int]] = None
    dst: Optional[Sequence[BytesLike]] = None

    def start(self) -> int:
        return self.extents[0][0] if self.extents else 0


def run_pipeline(backend: FileBackend, items: Sequence[ReadItem],
                 prefetch_bytes: int,
                 depth: Optional[int] = None) -> Iterator[Tuple[Any, List]]:
    """Execute ``items`` against ``backend``; yield ``(key, results)``.

    ``results`` has one entry per extent: the filled ``dst`` buffer (or an
    allocated ``bytearray``) for raw items, inflated ``bytes`` for
    ``inflate`` items.  Results are yielded as they complete — raw items
    complete immediately, inflate items complete when their pool futures
    resolve, bounded by ``depth`` in-flight items (default: the codec pool
    width, so the queue can keep every pool thread busy).

    ``prefetch_bytes <= 0`` is the serial mode: no background reads, no
    pool, extents consumed strictly in order — the oracle the pipelined
    mode is tested against.
    """
    items = list(items)
    serial = prefetch_bytes <= 0
    width = max(1, codec.pool_width())
    depth = depth if depth is not None else max(2, width)
    flat: List[Extent] = [e for it in items for e in it.extents]
    pf_i = 0
    inflight: List[Tuple[Any, List, int]] = []  # (key, futures, est bytes)
    inflight_bytes = 0
    # In-flight jobs pin both their compressed buffers and their inflated
    # results until drained, so the queue is bounded by BYTES as well as
    # item count — the prefetch window only governs the read cache, and
    # a checkpoint of huge leaves must not hold pool-width whole leaves
    # in memory at once.  One item beyond the head always stays in
    # flight so read/inflate overlap survives the cap.
    byte_cap = max(4 * prefetch_bytes, 64 << 20)
    released = 0
    c = _trace.collector()

    def _drain_head() -> Tuple[Any, List]:
        nonlocal inflight_bytes
        key, futs, est = inflight.pop(0)
        inflight_bytes -= est
        if c is not None:
            c.counter("restore.in_flight_bytes", inflight_bytes)
        out: List[bytes] = []
        for f in futs:  # each future resolves to a batch of payloads
            out.extend(f.result())
        return key, out

    try:
        for idx, it in enumerate(items):
            if not serial:
                pf_i += backend.prefetch(flat, window=prefetch_bytes,
                                         start=pf_i)
            if it.dst is not None:
                bufs: List[BytesLike] = list(it.dst)
                backend.read_scatter(
                    zip((off for off, _ in it.extents), bufs))
            else:
                # no caller buffer to fill — serve prefetched extents as
                # zero-copy views instead of allocating and memcpy-ing
                bufs = backend.read_extents(it.extents)
            if not it.inflate:
                yield it.key, bufs
            elif serial:
                out = []
                for j, b in enumerate(bufs):
                    raw = codec.decompress(b)
                    if it.expected_sizes is not None \
                            and len(raw) != it.expected_sizes[j]:
                        raise ScdaError(
                            ScdaErrorCode.CORRUPT_CHECKSUM,
                            f"element inflated to {len(raw)}, "
                            f"U-entry says {it.expected_sizes[j]}")
                    out.append(raw)
                yield it.key, out
            else:
                # A few multi-chunk jobs instead of one future per chunk:
                # enough slices to keep every pool thread busy, few enough
                # that worker wakeups don't GIL-starve this thread.
                step = max(1, -(-len(bufs) // (2 * width)))
                futs = []
                for j in range(0, len(bufs), step):
                    sizes = (it.expected_sizes[j:j + step]
                             if it.expected_sizes is not None else None)
                    futs.append(codec.submit_decompress_batch(
                        bufs[j:j + step], sizes))
                est = (sum(n for _, n in it.extents)
                       + sum(it.expected_sizes or ()))
                inflight.append((it.key, futs, est))
                inflight_bytes += est
                if c is not None:
                    c.counter("restore.in_flight_bytes", inflight_bytes)
                    c.counter("restore.in_flight_items", len(inflight))
                while inflight and (len(inflight) > depth
                                    or (inflight_bytes > byte_cap
                                        and len(inflight) > 1)
                                    or all(f.done()
                                           for f in inflight[0][1])):
                    yield _drain_head()
            if not serial:
                # Everything before the next item's first extent has been
                # consumed (items are offset-sorted) — give it back in
                # half-window batches: big enough to amortize fadvise
                # (DONTNEED is not free, on network file systems in
                # particular), small enough that prefetch budget frees
                # mid-window and read-ahead of the next window overlaps
                # consumption of this one.  Capped at 4 MiB so huge
                # windows still release promptly.
                nxt = (items[idx + 1].start() if idx + 1 < len(items)
                       else max((o + n for o, n in it.extents), default=0))
                if nxt - released >= min(max(1, prefetch_bytes // 2),
                                         1 << 22) \
                        or idx + 1 == len(items):
                    backend.release(nxt)
                    released = nxt
        while inflight:
            yield _drain_head()
    finally:
        # Error or early close: no future may outlive the generator (the
        # backend fd is about to go away under the prefetcher and pool).
        for _, futs, _est in inflight:
            for f in futs:
                f.cancel()
        for _, futs, _est in inflight:
            for f in futs:
                if not f.cancelled():
                    try:
                        f.result()
                    except BaseException:  # noqa: BLE001 - shutdown path
                        pass  # primary error already propagating
        inflight.clear()


# --------------------------------------------------------------------------
# The write mirror: snapshot → deflate → pwritev
# --------------------------------------------------------------------------

@dataclasses.dataclass
class WriteItem:
    """One schedulable unit of the save pipeline (typically a leaf).

    ``snapshot`` produces the item's payload (device→host for jax
    arrays); the engine runs it one item ahead on the shared pool so the
    copy overlaps the previous item's deflate/write.  With ``deflate``
    the payload must be a sequence of independent chunk buffers; the
    engine compresses each with the §3.1 algorithm (``level``/``style``)
    on the codec pool and hands ``plan`` the finished streams.  Without
    it, ``plan`` receives the snapshot payload verbatim.

    ``plan(payload) -> [(offset, buffer), ...]`` turns the final payload
    into absolute-offset write fragments.  Plans are invoked STRICTLY in
    item order — an item's offsets may depend on every predecessor's
    planned size (the §3.4 compressed case), so schedulers keep their
    cursor in the closure and advance it per call.  The fragments are
    then queued out-of-order-safe on the writeback executor (positioned
    writes at disjoint offsets commute).
    """
    key: Any
    snapshot: Callable[[], Any]
    plan: Callable[[Any], List[Tuple[int, BytesLike]]]
    deflate: bool = False
    level: Optional[int] = None
    style: str = spec.UNIX


def run_write_pipeline(backend: FileBackend, items: Sequence[WriteItem],
                       window: int, depth: Optional[int] = None) -> int:
    """Execute write ``items`` against ``backend``; returns bytes queued.

    ``window <= 0`` is the serial mode: snapshot, deflate, and write run
    strictly in item order on this thread with plain synchronous
    :meth:`FileBackend.write_gather` — the oracle the pipelined mode is
    tested against.  Otherwise snapshots run one item ahead, in-flight
    items (snapshotted payloads and deflate jobs alike) are bounded by
    ``depth`` (default: codec pool width) AND by bytes
    (``max(4 * window, 64 MiB)`` of raw payload — a checkpoint of huge
    leaves must not pin pool-width whole leaves), and writes drain in
    the background within ``window`` in-flight bytes.

    The engine drains the writeback queue before returning, so every
    error — deflate, plan, or write — surfaces HERE as the serial
    path's :class:`ScdaError`, with no future left running.
    """
    items = list(items)
    total = 0
    if window <= 0:
        for it in items:
            payload = it.snapshot()
            if it.deflate:
                payload = [codec.compress(c, it.style,
                                          _level(it)) for c in payload]
            frags = it.plan(payload)
            total += sum(len(b) for _, b in frags)
            backend.write_gather(frags)
        return total

    width = max(1, codec.pool_width())
    depth = depth if depth is not None else max(2, width)
    byte_cap = max(4 * window, 64 << 20)
    snaps = {}    # idx -> snapshot Future
    pend = {}     # idx -> (deflate futures or None, payload, est bytes)
    pend_bytes = 0
    sub = 0       # next item to move snapshot → deflate
    c = _trace.collector()

    def _ensure_snap(j: int) -> None:
        if j < len(items) and j not in snaps and j not in pend:
            fn = items[j].snapshot
            if c is not None:
                def fn(snap=fn, j=j):  # traced worker-side span
                    with c.span("snapshot", "pipeline", item=j):
                        return snap()
            snaps[j] = codec.submit_task(fn)

    try:
        for idx, it in enumerate(items):
            # Submission runs ahead of emission: move items onto the
            # codec pool until the in-flight caps say stop.  The current
            # item (sub == idx) always submits, and one item beyond the
            # head always stays in flight so deflate/write overlap
            # survives the cap.
            while sub < len(items) and (
                    sub <= idx
                    or (sub - idx <= depth and pend_bytes <= byte_cap)):
                jt = items[sub]
                _ensure_snap(sub)
                _ensure_snap(sub + 1)  # the double buffer
                payload = snaps.pop(sub).result()
                if jt.deflate:
                    chunks = list(payload)
                    est = sum(len(c) for c in chunks)
                    # A few multi-chunk jobs, as on the read side: enough
                    # slices to keep the pool busy, few enough that
                    # worker wakeups don't GIL-starve this thread.
                    step = max(1, -(-len(chunks) // (2 * width)))
                    futs = [codec.submit_compress_batch(
                        chunks[j:j + step], _level(jt))
                        for j in range(0, len(chunks), step)]
                    pend[sub] = (futs, None, est)
                else:
                    est = _est_bytes(payload)
                    pend[sub] = (None, payload, est)
                pend_bytes += est
                sub += 1
                if c is not None:
                    c.counter("save.pend_bytes", pend_bytes)
                    c.counter("save.pend_items", len(pend))
            futs, payload, est = pend.pop(idx)
            pend_bytes -= est
            if futs is not None:
                streams: List[bytes] = []
                t0 = c.now() if c is not None else 0
                for f in futs:
                    streams.extend(codec.encode_stage2(s1, it.style)
                                   for s1 in f.result())
                if c is not None:
                    c.end("encode", "codec", t0,
                          {"elements": len(streams),
                           "bytes": sum(map(len, streams))})
                frags = it.plan(streams)
            else:
                frags = it.plan(payload)
            total += sum(len(b) for _, b in frags)
            backend.submit_write_gather(frags, window)
        backend.drain_writes()
        return total
    finally:
        # Error or early exit: no future may outlive this call (the
        # backend fd is about to go away under the writeback pool).
        leaked = list(snaps.values())
        for futs, _, _ in pend.values():
            leaked.extend(futs or ())
        for f in leaked:
            f.cancel()
        for f in leaked:
            if not f.cancelled():
                try:
                    f.result()
                except BaseException:  # noqa: BLE001 - shutdown path
                    pass  # primary error already propagating
        snaps.clear()
        pend.clear()
        try:
            backend.drain_writes()
        except (ScdaError, _faults.SimulatedCrash):
            # the primary error is already propagating; the drain only
            # guarantees quiescence here
            pass


def _level(it: WriteItem) -> int:
    return codec.DEFAULT_LEVEL if it.level is None else it.level


def _est_bytes(payload) -> int:
    """Best-effort size of a raw snapshot payload for the in-flight byte
    cap: a buffer, or a list/tuple of buffers / ``(offset, buffer)``
    fragments (the checkpoint scheduler's window lists).  Anything else
    — notably one-shot iterables, which must reach ``plan`` unconsumed —
    counts 0: the item-depth cap still bounds it, just not by bytes."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return len(payload)
    if not isinstance(payload, (list, tuple)):
        return 0
    try:
        total = 0
        for entry in payload:
            total += len(entry[-1] if isinstance(entry, tuple) else entry)
        return total
    except TypeError:
        return 0
