"""Positioned file I/O — the MPI-IO role (``MPI_File_write_at``) in scda.

Every rank holds its own descriptor onto the shared file and performs
positioned reads/writes at offsets computed *deterministically* from
collective section parameters.  No rank ever seeks relative to another —
that independence is what makes the write path scale and the bytes
partition-independent.

On a parallel file system (Lustre, GPFS) this maps 1:1 to MPI-IO or
per-node POSIX pwrite; on this container it is plain POSIX.  File-system
errors are translated to the paper's group-2 error codes.

Fast-path machinery (all byte-transparent):

* :meth:`FileBackend.pwritev` — vectored positioned writes (``os.pwritev``):
  a section's header, count entries, payload view, and padding go down in
  one syscall without concatenating (= copying) the payload.  Falls back to
  a sequential ``pwrite`` loop where the platform lacks ``pwritev``.
* :meth:`FileBackend.write_gather` — takes a scatter-gather list of
  ``(offset, buffer)`` fragments and coalesces *adjacent* fragments into
  single vectored writes, so a whole contiguous section becomes one syscall.
* :meth:`FileBackend.read_scatter` — the read mirror of ``write_gather``:
  fills ``(offset, buffer)`` fragments via ``os.preadv``, coalescing
  adjacent fragments into single vectored reads (IOV_MAX batching, partial
  reads resumed, EOF raises CORRUPT_TRUNCATED instead of spinning).
* A configurable readahead cache for mode ``'r'`` so metadata scans
  (64-byte section headers, 32-byte count entries) stop issuing tiny
  ``pread`` syscalls.  ``REPRO_SCDA_READAHEAD`` (bytes) tunes it; ``0``
  disables.  Large payload reads bypass the cache entirely.  The window is
  seek-aware: :meth:`FileBackend.refit_readahead` drops and re-fits it at a
  jump target instead of serving the first post-seek reads cold.
* A background prefetch executor (:meth:`FileBackend.prefetch`) that
  double-buffers upcoming extents for the overlapped restore engine
  (:mod:`repro.core.pipeline`): reads land in a bounded cache consulted by
  ``pread``/``read_scatter``; :meth:`FileBackend.release` drops consumed
  buffers and hands the pages back with ``posix_fadvise(DONTNEED)``.
* The write mirror of the prefetcher: :meth:`FileBackend.submit_write_gather`
  queues gather writes on a small background executor with BOUNDED
  in-flight bytes (``REPRO_SCDA_WRITE_PIPELINE`` window; submission blocks
  while the window is full), so the overlapped save engine can deflate
  leaf k+1 while leaf k's ``pwritev`` is still on its way to disk.
  :meth:`FileBackend.drain_writes` is the completion drain: it waits for
  every queued write and raises the first failure as the exact
  :class:`ScdaError` the foreground write would have raised.  Positioned
  writes at disjoint offsets commute, so background completion order never
  affects the bytes.
"""
from __future__ import annotations

import errno as _errno
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from repro_torch.core import faults as _faults
from repro_torch.core import trace as _trace
from repro_torch.core.errors import (TRANSIENT_ERRNOS, ScdaError, ScdaErrorCode,
                               os_error_detail)

BytesLike = Union[bytes, bytearray, memoryview]

#: Consecutive zero-progress pwrite/pwritev returns tolerated before the
#: backend gives up with FS_WRITE (a 0-byte return must never spin forever).
MAX_ZERO_PROGRESS = 8

#: Default bound on transient-errno retries (EINTR immediately, EAGAIN
#: with exponential backoff) before a syscall aborts as a group-2 error;
#: ``REPRO_SCDA_RETRIES`` overrides.  Non-transient errnos — ENOSPC and
#: EIO above all — are never retried: retrying cannot unfill a disk, and
#: the caller's cleanup contract (tmp sweep) wants the error promptly.
DEFAULT_RETRIES = 16


def max_retries() -> int:
    """The effective transient-retry bound, read from the environment per
    call (cheap, and lets tests flip the knob without re-importing)."""
    raw = os.environ.get("REPRO_SCDA_RETRIES", "")
    try:
        return max(0, int(raw)) if raw else DEFAULT_RETRIES
    except ValueError:
        return DEFAULT_RETRIES

#: Default readahead window for mode-'r' backends (bytes); env-overridable.
DEFAULT_READAHEAD = int(os.environ.get("REPRO_SCDA_READAHEAD", str(64 << 10)))

#: Default prefetch window for the overlapped restore engine (bytes).
#: ``REPRO_SCDA_PREFETCH`` overrides; ``0`` disables prefetch entirely,
#: which makes every pipelined code path degrade to the serial read order.
DEFAULT_PREFETCH = 4 << 20


def prefetch_window() -> int:
    """The effective prefetch window, read from the environment per call
    (cheap, and lets tests flip the knob without re-importing)."""
    raw = os.environ.get("REPRO_SCDA_PREFETCH", "")
    try:
        return max(0, int(raw)) if raw else DEFAULT_PREFETCH
    except ValueError:
        return DEFAULT_PREFETCH


#: Default in-flight byte window for the overlapped save engine.
#: ``REPRO_SCDA_WRITE_PIPELINE`` overrides; ``0`` disables pipelined
#: writes entirely — every save degrades to the exact legacy serial
#: write order, which is the byte oracle the pipeline is tested against.
#: 32 MiB: large enough that two whole default-chunked leaves can be in
#: flight on both writeback workers (an 8 MiB window measured *slower*
#: than serial on raw saves — one leaf filled it and serialized the
#: queue), small enough to bound a save's extra memory.
DEFAULT_WRITE_PIPELINE = 32 << 20


def write_pipeline_window() -> int:
    """The effective write-pipeline window (bytes), read per call like
    :func:`prefetch_window`; ``0`` = serial saves."""
    raw = os.environ.get("REPRO_SCDA_WRITE_PIPELINE", "")
    try:
        return max(0, int(raw)) if raw else DEFAULT_WRITE_PIPELINE
    except ValueError:
        return DEFAULT_WRITE_PIPELINE


_HAS_PWRITEV = hasattr(os, "pwritev")
_HAS_PREADV = hasattr(os, "preadv")
try:
    _IOV_MAX = os.sysconf("SC_IOV_MAX")
    if _IOV_MAX <= 0:
        _IOV_MAX = 1024
except (AttributeError, ValueError, OSError):  # pragma: no cover
    _IOV_MAX = 1024

#: Consecutive fragments at or below this size are concatenated in user
#: space before the vectored write: copying a few KB costs less than the
#: kernel's per-iovec-segment processing, while big payload views are
#: always passed through zero-copy.
_JOIN_SMALL = 8 << 10


def as_byte_view(data: BytesLike) -> memoryview:
    """Normalize any buffer to a flat uint8 memoryview (zero-copy)."""
    v = memoryview(data)
    return v if v.format == "B" and v.ndim == 1 else v.cast("B")


_as_view = as_byte_view


class FileBackend:
    """One rank's positioned-I/O handle on the shared file."""

    def __init__(self, path: str, mode: str, create: bool,
                 readahead: Optional[int] = None) -> None:
        self.path = path
        self.mode = mode
        # Per-backend fault injector (faults.FaultBackend sets it); the
        # instrumented syscall wrappers also consult the process-wide /
        # REPRO_SCDA_FAULTS plans, so this stays None in production.
        self._inj = None
        flags = os.O_RDONLY
        if mode == "w":
            # fopen('w') semantics (§A.3): create new or truncate existing.
            flags = os.O_RDWR | os.O_CREAT
            if create:
                flags |= os.O_TRUNC
        elif mode == "a":
            # fopen('a') semantics: the file must already exist and is
            # never truncated at open — the writer validates the tail and
            # resumes its cursor there.  Reads (tail checks, probes) and
            # positioned writes both work on the one descriptor; the
            # writeback executor is available exactly as in mode 'w'.
            flags = os.O_RDWR
        try:
            self.fd = _faults.os_open(path, flags, 0o644)
        except OSError as e:
            raise ScdaError(ScdaErrorCode.FS_OPEN, f"{path}: {e}") from e
        # Readahead only makes sense for mode 'r': the file is immutable
        # while a reader holds it, so a stale-cache hazard cannot arise.
        self._readahead = (DEFAULT_READAHEAD if readahead is None
                           else readahead) if mode == "r" else 0
        self._cache: bytes = b""
        self._cache_off = 0
        # Prefetch state (mode 'r' only; executor is created lazily on the
        # first prefetch() call so serial readers never pay for a thread).
        self._pf_lock = threading.Lock()
        self._pf: Dict[int, Tuple[int, "Future"]] = {}  # off -> (len, fut)
        self._pf_pool = None
        # Writeback state (mode 'w' only; executor created lazily on the
        # first submit_write_gather so serial writers never pay for it).
        self._wb_lock = threading.Lock()
        # (future, bytes queued, start offset) — the offset rides along so
        # a background failure can name the fragment run that was lost.
        self._wb: List[Tuple["Future", int, int]] = []
        self._wb_pool = None
        self._wb_error: Optional[BaseException] = None
        # Sticky copy of the first failure: _wb_error is cleared once
        # drain_writes has delivered it, but the file stays poisoned —
        # later submissions must keep failing fast (a lost fragment
        # cannot be unlost by writing more).  ScdaError, or a
        # SimulatedCrash from the fault harness (never wrapped).
        self._wb_poison: Optional[BaseException] = None

    def _transient_retry(self, e: OSError, code: ScdaErrorCode,
                         offset: Optional[int], attempt: int) -> int:
        """Classify an OSError mid-loop: transient errnos (EINTR/EAGAIN)
        are always retried — EINTR immediately, per POSIX restart
        semantics; EAGAIN with capped exponential backoff — up to
        ``REPRO_SCDA_RETRIES`` times.  Everything else (ENOSPC, EIO, …)
        aborts NOW as the exact taxonomy error with the failing byte
        offset attached.  Returns the next attempt count."""
        if e.errno in TRANSIENT_ERRNOS and attempt < max_retries():
            c = _trace.collector()
            if c is not None:
                c.metrics.count("io.retries")
                c.event("retry", "io", path=self.path, errno=e.errno)
            if e.errno != _errno.EINTR:  # EINTR immediate; EAGAIN backs off
                time.sleep(min(0.001 * (1 << min(attempt, 6)), 0.05))
            return attempt + 1
        raise ScdaError(code, os_error_detail(self.path, offset, e, attempt),
                        offset=offset) from e

    # -- writes ---------------------------------------------------------------
    def pwrite(self, offset: int, data: BytesLike) -> None:
        view = _as_view(data)
        written, stalls, attempt = 0, 0, 0
        while written < len(view):
            try:
                n = _faults.os_pwrite(self.fd, view[written:],
                                      offset + written, path=self.path,
                                      inj=self._inj)
            except OSError as e:
                attempt = self._transient_retry(
                    e, ScdaErrorCode.FS_WRITE, offset + written, attempt)
                continue
            attempt = 0
            if n == 0:
                stalls += 1
                if stalls >= MAX_ZERO_PROGRESS:
                    raise ScdaError(
                        ScdaErrorCode.FS_WRITE,
                        f"{self.path}@{offset + written}: no write progress "
                        f"after {stalls} attempts",
                        offset=offset + written)
            else:
                stalls = 0
            written += n

    def pwritev(self, offset: int, buffers: Sequence[BytesLike]) -> None:
        """Write ``buffers`` contiguously at ``offset`` in as few syscalls
        as possible, without concatenating them in user space."""
        views: List[memoryview] = []
        small: List[memoryview] = []
        for b in buffers:
            v = _as_view(b)
            if not len(v):
                continue
            if len(v) <= _JOIN_SMALL:
                small.append(v)
                continue
            if small:  # join the run of small fragments, keep v zero-copy
                views.append(small[0] if len(small) == 1
                             else memoryview(b"".join(small)))
                small = []
            views.append(v)
        if small:
            views.append(small[0] if len(small) == 1
                         else memoryview(b"".join(small)))
        if not views:
            return
        # A run whose fragments all pre-joined used to collapse to ONE
        # view and silently degrade to pwrite — a different syscall with
        # its own stall counter, invisible to fault injection (and
        # accounting) at the pwritev layer.  Small-fragment runs now stay
        # on the vectored path whenever the platform has one, so every
        # gathered write shares a single zero-progress budget.
        if not _HAS_PWRITEV:  # pragma: no cover - exercised on exotic hosts
            for v in views:
                self.pwrite(offset, v)
                offset += len(v)
            return
        i, stalls, attempt = 0, 0, 0
        while i < len(views):
            batch = views[i:i + _IOV_MAX]
            try:
                n = _faults.os_pwritev(self.fd, batch, offset,
                                       path=self.path, inj=self._inj)
            except OSError as e:
                attempt = self._transient_retry(
                    e, ScdaErrorCode.FS_WRITE, offset, attempt)
                continue
            attempt = 0
            if n == 0:
                stalls += 1
                if stalls >= MAX_ZERO_PROGRESS:
                    raise ScdaError(
                        ScdaErrorCode.FS_WRITE,
                        f"{self.path}@{offset}: no write progress after "
                        f"{stalls} attempts", offset=offset)
                continue
            stalls = 0
            offset += n
            # Consume n bytes of the iovec list (partial writes resume
            # mid-buffer on the next iteration).
            while i < len(views) and n >= len(views[i]):
                n -= len(views[i])
                i += 1
            if i < len(views) and n:
                views[i] = views[i][n:]

    @staticmethod
    def _coalesce_runs(frags: Iterable[Tuple[int, BytesLike]]):
        """Group ``(offset, buffer)`` fragments into maximal contiguous
        runs, yielding ``(run_offset, run_bytes, buffers)``.  Fragments
        must arrive in non-decreasing offset order; zero-length buffers
        are skipped.  Shared by :meth:`write_gather` and
        :meth:`read_scatter` so the two sides can never diverge."""
        run_off = 0
        run_end = None
        bufs: List[BytesLike] = []
        for off, buf in frags:
            length = len(buf)
            if length == 0:
                continue
            if run_end is not None and off != run_end:
                yield run_off, run_end - run_off, bufs
                bufs = []
                run_end = None
            if run_end is None:
                run_off = run_end = off
            bufs.append(buf)
            run_end += length
        if bufs:
            yield run_off, run_end - run_off, bufs

    def write_gather(self,
                     frags: Iterable[Tuple[int, BytesLike]]) -> None:
        """Write ``(offset, buffer)`` fragments, coalescing adjacent runs.

        Fragments must arrive in non-decreasing offset order; each maximal
        contiguous run becomes a single vectored write.  Zero-length
        buffers are skipped.  Buffers must be bytes-like with ``len()`` in
        bytes (i.e. flat uint8 views — what the writer produces).
        """
        for run_off, _, bufs in self._coalesce_runs(frags):
            self.pwritev(run_off, bufs)

    # -- background writeback (the overlapped save engine's drain) ------------
    def submit_write_gather(self,
                            frags: Iterable[Tuple[int, BytesLike]],
                            window: int) -> None:
        """Queue ``frags`` for a background :meth:`write_gather`.

        The write mirror of :meth:`prefetch`: fragments are handed to a
        small executor and this call returns as soon as the queue has
        room — it BLOCKS (oldest-first) while more than ``window`` bytes
        are in flight, which is the pipeline's memory bound and the
        back-pressure that keeps a fast producer from buffering a whole
        checkpoint.  The caller's buffers are pinned by the queued job
        and must not be mutated until :meth:`drain_writes`.

        A failed background write surfaces as the exact
        :class:`ScdaError` the foreground :meth:`write_gather` would have
        raised — here on the next submission, or at the latest from
        :meth:`drain_writes`/:meth:`close`.  After a failure all later
        submissions fail fast without queueing, permanently — the
        poison survives :meth:`drain_writes` delivering the error (the
        file is already missing fragments; more writes cannot unpoison
        it), including submissions on the ``window <= 0`` serial path.

        ``window <= 0`` degrades to a plain synchronous
        :meth:`write_gather` — the serial oracle.
        """
        with self._wb_lock:
            self._reap_done_locked()
            self._raise_poison_locked()
        if window <= 0:
            self.write_gather(frags)
            return
        frags = [(off, buf) for off, buf in frags if len(buf)]
        nbytes = sum(len(buf) for _, buf in frags)
        off0 = frags[0][0] if frags else 0
        c = _trace.collector()
        if c is None:
            job = self.write_gather
        else:
            def job(frags=frags):  # traced worker-side span
                with c.span("writeback", "pipeline", path=self.path,
                            offset=off0, bytes=nbytes):
                    self.write_gather(frags)
        with self._wb_lock:
            if self._wb_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                # Two workers: one write landing while the next queues.
                self._wb_pool = ThreadPoolExecutor(
                    max_workers=2, thread_name_prefix="scda-writeback")
        while True:
            with self._wb_lock:
                self._reap_done_locked()
                self._raise_poison_locked()
                inflight = sum(t[1] for t in self._wb)
                if not self._wb or inflight + nbytes <= window:
                    self._wb.append((
                        self._wb_pool.submit(job, frags) if c is None
                        else self._wb_pool.submit(job), nbytes, off0))
                    if c is not None:
                        c.counter("writeback.in_flight_bytes",
                                  inflight + nbytes)
                        c.counter("writeback.queue_depth", len(self._wb))
                    return
                head = self._wb[0][0]
            if c is not None:
                c.metrics.count("pipeline.writeback.stalls")
            # Oldest-first wait OUTSIDE the lock (the reap and
            # pending_write_bytes must stay reachable meanwhile):
            # submission order is also file order, so draining the head
            # frees window budget soonest.
            try:
                head.result()
            except BaseException:  # noqa: BLE001 - reap owns delivery
                pass  # recorded by the next reap; raised after accounting

    def _raise_poison_locked(self) -> None:
        """Fail fast on a poisoned backend, consuming the one-shot
        ``_wb_error`` delivery so a later drain/close does not re-raise
        an error this submission already handed to the caller."""
        if self._wb_poison is not None:
            self._wb_error = None
            raise self._wb_poison

    def _reap_done_locked(self) -> None:
        """Drop completed writeback jobs; record the first failure.

        A failure that crossed the executor boundary has lost the
        submitting stack, so the submission-time op context (stage, path,
        offset, bytes) is re-attached here: as ``op_context``/``stage``
        attributes plus an exception note (3.11+), never by rewriting the
        message — background errors must stay byte-identical to the
        foreground ones the pipeline fuzz compares against.
        """
        still = []
        for fut, n, off in self._wb:
            if fut.done():
                err = fut.exception()
                if err is not None and self._wb_poison is None:
                    # A SimulatedCrash must stay a crash — wrapping it in
                    # FS_WRITE would let the taxonomy "handle" power loss.
                    if isinstance(err, (ScdaError, _faults.SimulatedCrash)):
                        self._wb_poison = err
                    else:
                        wrapped = ScdaError(
                            ScdaErrorCode.FS_WRITE,
                            f"{self.path}: background writeback of {n} "
                            f"bytes @ {off}: {err}")
                        wrapped.__cause__ = err
                        self._wb_poison = wrapped
                    self._attach_op_context(
                        self._wb_poison, "writeback", off, n)
                    self._wb_error = self._wb_poison
            else:
                still.append((fut, n, off))
        self._wb[:] = still

    def _attach_op_context(self, err: BaseException, stage: str,
                           offset: int, nbytes: int) -> None:
        """Pin the failed stage onto an error surfaced from a pool worker
        (satellite of the telemetry PR): ``err.op_context`` for callers,
        an exception note for tracebacks, and a trace event when live."""
        err.stage = stage
        err.op_context = {"stage": stage, "path": self.path,
                          "offset": offset, "bytes": nbytes}
        note = getattr(err, "add_note", None)
        if note is not None:  # Python 3.11+
            try:
                note(f"stage: {stage} ({self.path} @ {offset}, "
                     f"{nbytes} bytes)")
            except TypeError:  # pragma: no cover - exotic BaseExceptions
                pass
        c = _trace.collector()
        if c is not None:
            c.event("error", "pipeline", stage=stage, path=self.path,
                    offset=offset, bytes=nbytes, error=str(err))

    def drain_writes(self) -> None:
        """Wait for every queued background write; raise the first error.

        The save engine's completion drain: a successful return means
        every submitted fragment is handed to the kernel (durability is
        still :meth:`fsync`'s job, exactly as for foreground writes).
        Idempotent and a no-op when nothing was ever submitted; an error
        is delivered once (so a close after a handled failure does not
        re-raise and mask it), but the backend stays poisoned for
        further submissions.
        """
        with self._wb_lock:
            pending = list(self._wb)
        for fut, _, _ in pending:
            try:
                fut.result()
            except BaseException:  # noqa: BLE001 - reap owns delivery
                pass  # recorded by the reap below
        with self._wb_lock:
            self._reap_done_locked()
            err, self._wb_error = self._wb_error, None
        if err is not None:
            raise err

    def pending_write_bytes(self) -> int:
        """Bytes queued or in flight on the writeback executor (test hook —
        a clean shutdown must leave this at 0)."""
        with self._wb_lock:
            self._reap_done_locked()
            return sum(t[1] for t in self._wb)

    # -- reads ----------------------------------------------------------------
    def pread(self, offset: int, n: int) -> bytes:
        if n <= 0:
            return b""
        if self._pf:
            hit = self._take_prefetched(offset, n)
            if hit is not None:
                return bytes(hit)
        ra = self._readahead
        if ra and n <= ra:
            lo, cache = self._cache_off, self._cache
            if lo <= offset and offset + n <= lo + len(cache):
                i = offset - lo
                return cache[i:i + n]
            cache = self._pread_upto(offset, ra)
            self._cache_off, self._cache = offset, cache
            if len(cache) < n:
                raise ScdaError(
                    ScdaErrorCode.CORRUPT_TRUNCATED,
                    f"{self.path}: EOF at {offset + len(cache)}, wanted {n}",
                    offset=offset + len(cache))
            return cache[:n]
        return self._pread_exact(offset, n)

    def _pread_exact(self, offset: int, n: int) -> bytes:
        out = self._pread_upto(offset, n)
        if len(out) < n:
            raise ScdaError(
                ScdaErrorCode.CORRUPT_TRUNCATED,
                f"{self.path}: EOF at {offset + len(out)}, wanted {n}",
                offset=offset + len(out))
        return out

    def _pread_upto(self, offset: int, n: int) -> bytes:
        """Read up to ``n`` bytes; short only at end of file."""
        chunks: List[bytes] = []
        got, attempt = 0, 0
        while got < n:
            try:
                chunk = _faults.os_pread(self.fd, n - got, offset + got,
                                         path=self.path, inj=self._inj)
            except OSError as e:
                attempt = self._transient_retry(
                    e, ScdaErrorCode.FS_READ, offset + got, attempt)
                continue
            attempt = 0
            if not chunk:
                break
            chunks.append(chunk)
            got += len(chunk)
        if len(chunks) == 1:
            return chunks[0]
        return b"".join(chunks)

    def preadv(self, offset: int, bufs: Sequence[memoryview]) -> int:
        """Fill writable buffers contiguously from ``offset`` in as few
        syscalls as possible; returns bytes read (short only at EOF).

        The read mirror of :meth:`pwritev`: IOV_MAX batching and partial
        reads resumed mid-buffer.  A 0-byte return is EOF, never a stall,
        so the zero-progress guard here is simply to stop — callers decide
        whether a short fill is CORRUPT_TRUNCATED.
        """
        views = [v if isinstance(v, memoryview) else memoryview(v)
                 for v in bufs if len(v)]
        if not _HAS_PREADV:  # pragma: no cover - exercised on exotic hosts
            got = 0
            for v in views:
                data = self._pread_upto(offset + got, len(v))
                v[:len(data)] = data
                got += len(data)
                if len(data) < len(v):
                    break
            return got
        i, got, attempt = 0, 0, 0
        while i < len(views):
            batch = views[i:i + _IOV_MAX]
            try:
                n = _faults.os_preadv(self.fd, batch, offset + got,
                                      path=self.path, inj=self._inj)
            except OSError as e:
                attempt = self._transient_retry(
                    e, ScdaErrorCode.FS_READ, offset + got, attempt)
                continue
            attempt = 0
            if n == 0:  # EOF — no spinning possible on reads
                break
            got += n
            while i < len(views) and n >= len(views[i]):
                n -= len(views[i])
                i += 1
            if i < len(views) and n:
                views[i] = views[i][n:]
        return got

    def read_scatter(self,
                     frags: Iterable[Tuple[int, BytesLike]]) -> None:
        """Fill ``(offset, buffer)`` fragments, coalescing adjacent runs.

        The read mirror of :meth:`write_gather`: fragments must arrive in
        non-decreasing offset order; each maximal contiguous run becomes a
        single vectored read straight into the caller's buffers (no user
        space concatenation or copy).  Runs covered by a prefetched extent
        are served from the prefetch cache without a syscall.  A run that
        cannot be filled completely raises CORRUPT_TRUNCATED, exactly as
        :meth:`pread` would.
        """
        for run_off, total, bufs in self._coalesce_runs(frags):
            self._read_run(run_off, total, bufs)

    def _read_run(self, offset: int, total: int,
                  bufs: List[BytesLike]) -> None:
        if self._pf:
            hit = self._take_prefetched(offset, total)
            if hit is not None:
                pos = 0
                for b in bufs:
                    v = memoryview(b)
                    v[:] = hit[pos:pos + len(v)]
                    pos += len(v)
                return
        got = self.preadv(offset, [memoryview(b) for b in bufs])
        if got < total:
            raise ScdaError(
                ScdaErrorCode.CORRUPT_TRUNCATED,
                f"{self.path}: EOF at {offset + got}, wanted {total}",
                offset=offset + got)

    def read_extents(self, extents: Sequence[Tuple[int, int]]) \
            -> List[BytesLike]:
        """Read ``(offset, length)`` extents into per-extent buffers.

        Extents covered by a prefetched run are returned as ZERO-COPY
        views of the prefetch buffer (the §3 decode path only reads
        them); misses fall back to exact preads.  Raises
        CORRUPT_TRUNCATED on short data, like :meth:`pread`.
        """
        out: List[BytesLike] = []
        for off, n in extents:
            if n <= 0:
                out.append(b"")
                continue
            hit = self._take_prefetched(off, n) if self._pf else None
            out.append(hit if hit is not None
                       else self._pread_exact(off, n))
        return out

    # -- background prefetch (the overlapped restore engine's feeder) ---------
    def prefetch(self, extents: Sequence[Tuple[int, int]],
                 window: int, start: int = 0) -> int:
        """Schedule background reads of ``(offset, length)`` extents,
        beginning at index ``start``.

        Adjacent extents coalesce into single jobs; scheduling stops once
        ``window`` bytes are buffered or in flight (the double-buffering
        bound — :meth:`release` returns budget as the consumer advances).
        Returns how many extents past ``start`` were accepted (a prefix),
        so a caller can resume from the first unaccepted extent later by
        advancing ``start`` — without re-slicing its extent list each
        call.  Purely advisory: a failed or short prefetch read is
        re-issued (and its error raised) by the foreground
        ``pread``/``read_scatter`` that actually consumes the extent.
        No-op outside mode 'r'.
        """
        if self.mode != "r" or window <= 0 or self.fd < 0:
            return 0
        accepted = 0
        with self._pf_lock:
            budget = window - sum(ln for ln, _ in self._pf.values())
            if budget <= 0:
                return 0
            run_off = run_len = 0
            for k in range(start, len(extents)):
                off, n = extents[k]
                if n <= 0:
                    accepted += 1
                    continue
                if n > window:
                    # Never buffer an extent bigger than the whole window;
                    # count it accepted so the pipeline moves past it and
                    # the foreground read handles it directly.
                    if run_len:
                        budget -= self._submit_prefetch(run_off, run_len)
                        run_len = 0
                    accepted += 1
                    continue
                if run_len and off == run_off + run_len:
                    run_len += n
                else:
                    if run_len:
                        budget -= self._submit_prefetch(run_off, run_len)
                    run_off, run_len = off, n
                accepted += 1
                if run_len >= budget:  # window full (open run included)
                    break
            if run_len:
                self._submit_prefetch(run_off, run_len)
        return accepted

    def _submit_prefetch(self, offset: int, length: int) -> int:
        """Submit one coalesced run (caller holds the lock); returns the
        number of bytes newly scheduled (0 if already covered).

        A run whose head overlaps buffered/in-flight entries is trimmed
        to the uncovered tail — overwriting the dict entry instead (runs
        are keyed by offset) would orphan a still-running job and read
        the shared bytes twice, exactly on the boundary chunks adjacent
        items have in common."""
        trimmed = True
        while trimmed and length > 0:
            trimmed = False
            for po, (plen, _) in self._pf.items():
                if po <= offset < po + plen:
                    cut = min(po + plen - offset, length)
                    offset += cut
                    length -= cut
                    trimmed = True
                    break
        if length <= 0:
            return 0
        if self._pf_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            # Two workers: one extent landing while the next is in flight.
            self._pf_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="scda-prefetch")
        fd, path, inj = self.fd, self.path, self._inj

        def _job() -> bytes:
            # Routed through the fault layer so injected read faults hit
            # background prefetch too; a failing job is dropped by
            # _take_prefetched and the extent is re-read in the
            # foreground, which raises the exact ScdaError (with byte
            # offset) a never-prefetched read would have.
            chunks, got = [], 0
            while got < length:
                chunk = _faults.os_pread(fd, length - got, offset + got,
                                         path=path, inj=inj)
                if not chunk:
                    break  # short at EOF; consumer re-reads and raises
                chunks.append(chunk)
                got += len(chunk)
            return b"".join(chunks)

        c = _trace.collector()
        if c is not None:
            inner = _job

            def _job() -> bytes:  # noqa: F811 - traced worker-side span
                with c.span("prefetch", "pipeline", path=path,
                            offset=offset, bytes=length):
                    return inner()

        self._pf[offset] = (length, self._pf_pool.submit(_job))
        if c is not None:
            c.counter("prefetch.extents", len(self._pf))
        return length

    def _take_prefetched(self, offset: int, n: int) -> Optional[memoryview]:
        """A zero-copy view of [offset, offset+n) if a prefetched extent
        fully covers it, else None (the caller falls back to a real read).
        Waits for an in-flight job covering the range; a job that failed
        (OSError) is dropped so the foreground read reports the error."""
        with self._pf_lock:
            found = None
            for po, (plen, fut) in self._pf.items():
                if po <= offset and offset + n <= po + plen:
                    found = (po, plen, fut)
                    break
            if found is None:
                return None
        po, plen, fut = found
        try:
            data = fut.result()
        except OSError as e:
            # The foreground re-read owns error delivery; name the stage
            # that actually failed so diagnostics don't blame the re-read.
            self._attach_op_context(e, "prefetch", po, plen)
            with self._pf_lock:
                self._pf.pop(po, None)
            return None
        if offset + n > po + len(data):  # short at EOF
            return None
        return memoryview(data)[offset - po:offset - po + n]

    def release(self, upto: int) -> None:
        """Drop prefetched extents that end at or before ``upto`` and hand
        their pages back to the kernel (``DONTNEED``) — the restore engine
        calls this as it consumes the file front to back, so a long restore
        never grows the page cache beyond the prefetch window."""
        dropped = []
        with self._pf_lock:
            for po in list(self._pf):
                plen, fut = self._pf[po]
                if po + plen <= upto and fut.done():
                    del self._pf[po]
                    dropped.append((po, plen))
        for po, plen in dropped:
            self.advise(po, plen, "dontneed")
        if self._cache and self._cache_off + len(self._cache) <= upto:
            self._cache = b""

    def pending_prefetch(self) -> int:
        """Number of prefetch extents buffered or in flight (test hook —
        a clean shutdown must leave this at 0)."""
        with self._pf_lock:
            return len(self._pf)

    def refit_readahead(self, offset: int) -> None:
        """Seek-aware readahead: drop the window and re-fit it at ``offset``
        when a jump lands outside it, so post-seek metadata reads (the
        64-byte header check, count entries) are warm instead of each
        paying a cold miss.  No-op when readahead is disabled or the
        target is already inside the current window."""
        ra = self._readahead
        if not ra:
            return
        lo = self._cache_off
        if lo <= offset < lo + len(self._cache):
            return
        self._cache_off, self._cache = offset, self._pread_upto(offset, ra)

    # -- access-pattern hints -------------------------------------------------
    _ADVICE = {}
    if hasattr(os, "posix_fadvise"):  # pragma: no branch - platform constant
        _ADVICE = {
            "willneed": os.POSIX_FADV_WILLNEED,
            "sequential": os.POSIX_FADV_SEQUENTIAL,
            "random": os.POSIX_FADV_RANDOM,
            "dontneed": os.POSIX_FADV_DONTNEED,
        }

    def advise(self, offset: int, length: int, advice: str) -> None:
        """Advisory readahead hint (``posix_fadvise``); silently a no-op
        where the platform lacks it or the kernel declines.

        The index layer issues ``sequential`` for its one header-only scan
        and ``willneed`` for the extent of a section about to be read after
        a seek — random access should not pay sequential-readahead
        misprediction on a parallel file system.
        """
        fadv = self._ADVICE.get(advice)
        if fadv is None or self.fd < 0:
            return
        try:
            os.posix_fadvise(self.fd, offset, max(0, length), fadv)
        except OSError:  # advisory only — never an scda error
            pass

    # -- metadata / lifecycle -------------------------------------------------
    def size(self) -> int:
        try:
            return os.fstat(self.fd).st_size
        except OSError as e:
            raise ScdaError(ScdaErrorCode.FS_READ, str(e)) from e

    def truncate(self, n: int) -> None:
        try:
            _faults.os_ftruncate(self.fd, n, path=self.path, inj=self._inj)
        except OSError as e:
            raise ScdaError(ScdaErrorCode.FS_WRITE,
                            os_error_detail(self.path, n, e)) from e
        self._cache = b""  # cached bytes past the cut are stale

    def fsync(self) -> None:
        attempt = 0
        while True:
            try:
                _faults.os_fsync(self.fd, path=self.path, inj=self._inj)
                return
            except OSError as e:
                attempt = self._transient_retry(
                    e, ScdaErrorCode.FS_WRITE, None, attempt)

    def close(self, sync: bool = False) -> None:
        if self.fd < 0:
            return
        # Drain the prefetcher FIRST: background jobs read self.fd, so the
        # descriptor must stay open until every job has finished or been
        # cancelled.  shutdown(wait=True) guarantees no leaked futures.
        if self._pf_pool is not None:
            self._pf_pool.shutdown(wait=True, cancel_futures=True)
            self._pf_pool = None
        with self._pf_lock:
            self._pf.clear()
        # Same for the writeback executor: every queued write must reach
        # the kernel before fsync/close, and a failed one must surface as
        # the ScdaError the foreground write would have raised (after the
        # fd is closed — never leak it on the error path).
        wb_err: Optional[BaseException] = None
        if self._wb_pool is not None:
            try:
                self.drain_writes()
            except (ScdaError, _faults.SimulatedCrash) as e:
                wb_err = e
            self._wb_pool.shutdown(wait=True)
            self._wb_pool = None
        try:
            if sync and wb_err is None:
                try:
                    self.fsync()   # transient errnos retried like any fsync
                except ScdaError:
                    os.close(self.fd)   # never leak the fd on give-up
                    raise
            os.close(self.fd)
        except OSError as e:
            raise ScdaError(ScdaErrorCode.FS_CLOSE, str(e)) from e
        finally:
            self.fd = -1
            self._cache = b""
        if wb_err is not None:
            raise wb_err


# -- durable metadata helpers -------------------------------------------------
# An atomic rename is only the commit point once the *directory entry* is on
# disk: POSIX lets a power cut after os.replace() roll the rename back unless
# the parent directory is fsynced.  Every commit in the repo (checkpoint file,
# sidecar refresh, sharded manifest) goes through these helpers.

def fsync_dir(path: str) -> None:
    """fsync a directory so renames inside it survive a power cut."""
    try:
        _faults.os_fsync_dir(path or ".")
    except OSError as e:
        raise ScdaError(ScdaErrorCode.FS_WRITE,
                        f"{path}: directory fsync: {e}") from e


def replace_file(src: str, dst: str) -> None:
    """os.replace with the ScdaError taxonomy (and fault injection)."""
    try:
        _faults.os_replace(src, dst)
    except OSError as e:
        raise ScdaError(ScdaErrorCode.FS_WRITE,
                        f"{src} -> {dst}: {e}") from e


def replace_durable(src: str, dst: str) -> None:
    """Atomic rename plus parent-directory fsync: the full commit point."""
    replace_file(src, dst)
    fsync_dir(os.path.dirname(os.path.abspath(dst)))
