"""Parallel scda writer (paper §A.3–A.4).

All methods are collective over the communicator and must be called in the
same order on every rank with identical collective parameters (paper §A.2:
"it is an unchecked runtime error if they are indeed not collective" — we
*do* check what is cheaply checkable).  Every rank computes the identical
section layout from collective parameters and writes only its own windows
via positioned writes; rank 0 writes section metadata; the rank owning the
final data byte writes the '='-padding (its value depends on that byte).

This mirrors MPI_File_write_at usage in the reference libsc implementation
and keeps the file bytes invariant under the writing partition — the
serial-equivalence property at the heart of the paper.

Fast path: every section write assembles a scatter-gather list of
``(offset, buffer)`` fragments — header entries, count entries, payload
*views*, padding — and hands it to :meth:`FileBackend.write_gather`, which
coalesces adjacent fragments into single ``pwritev`` calls.  Payload bytes
are never concatenated or copied in user space; on one rank a whole
section is one syscall.  Varray count entries are generated vectorized
(:func:`repro.core.spec.count_entries`).

Durability: like MPI-IO (``MPI_File_sync`` is a separate, explicit call),
closing a file does *not* imply fsync.  Pass ``sync=True`` to
:func:`fopen_write`/:meth:`ScdaWriter.close` (or set ``REPRO_SCDA_FSYNC=1``)
for a collective close where every rank fsyncs after the final barrier —
the checkpoint layer does this before its atomic rename.

Mode 'a' (:func:`fopen_append`) reopens an existing archive, validates
its tail, and resumes the cursor so appended sections are byte-identical
to having written the longer file in one serial session — the journal
subsystem (:mod:`repro.journal`) streams training telemetry into the
same file a checkpoint lives in through exactly this path.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple, Union

from repro_torch.core import codec, partition, spec
from repro_torch.core import encode as _encode
from repro_torch.core.comm import Communicator, SerialComm
from repro_torch.core.errors import ScdaError, ScdaErrorCode
from repro_torch.core.io_backend import BytesLike, FileBackend, as_byte_view

DEFAULT_VENDOR = b"repro scda-jax 0.1"
assert len(DEFAULT_VENDOR) <= spec.VENDOR_MAX

#: Close-time fsync default (overridable per file / per close).
DEFAULT_SYNC = os.environ.get("REPRO_SCDA_FSYNC", "0") not in ("0", "", "no")

#: A window is (element_start, buffer): ``buffer`` covers elements
#: [element_start, element_start + len/E) of the section's global data.
Window = Tuple[int, BytesLike]

#: A write fragment: (absolute file offset, buffer view).
Frag = Tuple[int, BytesLike]


_as_bytes = as_byte_view


@dataclasses.dataclass(frozen=True)
class _TailInfo:
    """What mode-'a' tail validation learned about an existing archive."""
    end: int                 # resume cursor: one past the last valid section
    sections: int            # number of logical sections before the append
    style: str               # line-break style the original writer chose
    version: int
    vendor: bytes
    user_string: bytes
    truncate_to: Optional[int] = None  # recover=True: drop a torn tail here


def _validate_append_tail(path: str, recover: bool = False) -> _TailInfo:
    """Validate an archive's tail before appending (rank-local).

    Fast path: a fresh ``.scdax`` sidecar pins every section boundary, so
    only the *last* section needs re-validation — its on-disk header is
    re-read (stale sidecars fail loudly, as on every seek), its count
    entries and extent arithmetic are re-walked, and the section must end
    exactly on end of file.  Without a usable sidecar the whole stream is
    walked header-only (which also discovers the resume cursor).

    A truncated or garbage tail raises the exact :class:`ScdaError` the
    reader taxonomy defines (CORRUPT_TRUNCATED / CORRUPT_* with the
    failing byte offset attached); with ``recover`` the validated prefix
    boundary is returned in ``truncate_to`` instead, so the caller may
    drop a torn tail (the journal's self-healing append) — a corrupt
    *file header* is never recoverable.
    """
    from repro_torch.core.index import ScdaIndex
    from repro_torch.core.reader import fopen_read
    with fopen_read(None, path) as r:
        style = spec.detect_style(
            r._backend.pread(0, spec.FILE_HEADER_BYTES))

        def info(end: int, sections: int,
                 truncate_to: Optional[int] = None) -> _TailInfo:
            return _TailInfo(end=end, sections=sections, style=style,
                             version=r.version, vendor=r.vendor,
                             user_string=r.user_string,
                             truncate_to=truncate_to)

        idx = None
        try:
            idx = ScdaIndex.load_sidecar(path)  # size-verified
        except (ScdaError, OSError):
            idx = None
        if idx is not None and (idx.scda_version != r.version
                                or idx.vendor != r.vendor
                                or idx.user_string != r.user_string):
            idx = None  # same-size rewrite: fall back to the full walk
        if idx is not None:
            if not idx.entries:
                # Sidecar verified the size; an empty table means a bare
                # file header, which fopen_read above already validated.
                return info(spec.FILE_HEADER_BYTES, 0)
            try:
                r.set_index(idx)
                r.seek_section(len(idx.entries) - 1)  # on-disk header check
                r.skip_data()  # count entries + extent arithmetic
            except ScdaError:
                idx = None  # stale in a way the size probe missed
            else:
                if r.cursor != r._file_size:
                    if recover:
                        return info(r.cursor, len(idx.entries),
                                    truncate_to=r.cursor)
                    raise ScdaError(
                        ScdaErrorCode.CORRUPT_TRUNCATED,
                        f"{path}: {r._file_size - r.cursor} trailing bytes "
                        f"past the last section", offset=r.cursor)
                return info(r.cursor, len(idx.entries))
        # Full header-only walk: finds the resume cursor and validates
        # every section boundary on the way.
        r._pending = None
        r.cursor = spec.FILE_HEADER_BYTES
        sections = 0
        while not r.at_eof:
            boundary = r.cursor
            try:
                r.read_section_header(decode=True)
                r.skip_data()
            except ScdaError as e:
                if not recover:
                    raise e.at(boundary)
                return info(boundary, sections, truncate_to=boundary)
            sections += 1
        return info(r.cursor, sections)


#: Public aliases: ``scdatool repair`` and the crash-consistency harness
#: reuse the mode-'a' tail validator as the salvage primitive.
TailInfo = _TailInfo


def validate_tail(path: str, recover: bool = False) -> _TailInfo:
    """Validate an archive tail without opening it for append.

    With ``recover=False`` a damaged tail raises the reader's exact
    ``ScdaError``; with ``recover=True`` the result's ``truncate_to``
    marks the end of the longest valid section prefix (None when the
    whole file is clean).  A corrupt *file header* always raises.
    """
    return _validate_append_tail(path, recover=recover)


class ScdaWriter:
    """File context for modes 'w' (create/overwrite) and 'a' (append —
    reserved by the paper's fopen, implemented here): both resume the
    same positioned-write fast path, differing only in how the starting
    cursor is established."""

    def __init__(self, comm: Communicator, path: str,
                 user_string: bytes = b"",
                 vendor: bytes = DEFAULT_VENDOR,
                 style: str = spec.UNIX,
                 sync: Optional[bool] = None,
                 mode: str = "w",
                 recover: bool = False) -> None:
        self.comm = comm
        self.sync = DEFAULT_SYNC if sync is None else sync
        self._closed = False
        self.mode = mode
        if mode == "a":
            # Every rank validates the tail rank-locally (identical bytes
            # ⇒ identical verdicts, the §A.5.1 metadata pattern); only
            # then is the writable descriptor opened, so a corrupt file
            # is never opened for writing at all.  The original style is
            # detected from the file header: appended padding must match
            # it or the grown file would not be byte-identical to one
            # serial session.
            tail = _validate_append_tail(path, recover=recover)
            self._backend = FileBackend(path, "a", create=False)
            self.style = tail.style
            self.version = tail.version
            self.vendor = tail.vendor
            self.user_string = tail.user_string
            self.base_sections = tail.sections
            self.base_size = tail.end
            comm.barrier()
            if tail.truncate_to is not None and comm.rank == 0:
                self._backend.truncate(tail.truncate_to)
            self.cursor = tail.end
            comm.barrier()
            return
        if mode != "w":
            raise ScdaError(ScdaErrorCode.ARG_MODE,
                            f"unsupported open mode {mode!r}")
        self.style = style
        self.version = spec.FORMAT_VERSION
        self.vendor = vendor
        self.user_string = user_string
        self.base_sections = 0
        self.base_size = spec.FILE_HEADER_BYTES
        self._backend = FileBackend(path, "w", create=(comm.rank == 0))
        self.cursor = 0
        # Root lays down the file header (Fig. 1); everyone syncs before any
        # section writes so the truncate cannot clobber them.
        comm.barrier()
        if comm.rank == 0:
            header = spec.file_header(vendor, user_string, style)
            self._backend.truncate(0)
            self._backend.pwrite(0, header)
        self.cursor = spec.FILE_HEADER_BYTES
        comm.barrier()

    # -- context manager ----------------------------------------------------
    def __enter__(self) -> "ScdaWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ------------------------------------------------------------------ I --
    def write_inline(self, user_string: bytes, data: Optional[BytesLike],
                     root: int = 0) -> None:
        """§A.4.1 — MPI_Bcast semantics: data is significant on root only."""
        self._check_open()
        if self.comm.rank == root:
            if data is None or len(_as_bytes(data)) != spec.INLINE_DATA_BYTES:
                raise ScdaError(ScdaErrorCode.ARG_INLINE_SIZE,
                                f"got {0 if data is None else len(data)}")
            self._backend.pwritev(
                self.cursor,
                _encode.iov_inline(user_string, _as_bytes(data), self.style))
        else:
            spec.section_header(b"I", user_string, self.style)  # arg check
        self.cursor += spec.INLINE_SECTION_BYTES

    # ------------------------------------------------------------------ B --
    def write_block(self, user_string: bytes, data: Optional[BytesLike],
                    E: Optional[int] = None, root: int = 0,
                    encode: bool = False) -> None:
        """§A.4.2 — global data block from ``root``; optional §3 encoding."""
        self._check_open()
        if encode:
            self._write_block_encoded(user_string, data, root)
            return
        if E is None:
            E = self.comm.bcast(
                len(_as_bytes(data)) if self.comm.rank == root else None, root)
        if self.comm.rank == root:
            view = _as_bytes(data)
            if len(view) != E:
                raise ScdaError(ScdaErrorCode.ARG_DATA_SIZE,
                                f"block data {len(view)} != E {E}")
            self._backend.pwritev(
                self.cursor, _encode.iov_block(user_string, view, self.style))
        self.cursor += spec.block_section_bytes(E)

    def _write_block_encoded(self, user_string: bytes,
                             data: Optional[BytesLike], root: int) -> None:
        """§3.2 — I(magic, U-entry) followed by B(user, compressed)."""
        if self.comm.rank == root:
            view = _as_bytes(data)
            u = len(view)
            compressed = codec.compress(view, self.style)
            meta = codec.uncompressed_size_entry(u, self.style)
            self.write_inline(codec.MAGIC_BLOCK, meta, root)
            # Compressed size must reach all ranks for cursor bookkeeping.
            self.comm.bcast(len(compressed), root)
            self.write_block(user_string, compressed, len(compressed), root)
        else:
            self.write_inline(codec.MAGIC_BLOCK, None, root)
            csize = self.comm.bcast(None, root)
            self.write_block(user_string, None, csize, root)

    # ------------------------------------------------------------------ A --
    def write_array(self, user_string: bytes,
                    local_data: Union[BytesLike, Sequence[BytesLike], None],
                    counts: Sequence[int], E: int,
                    indirect: bool = False, encode: bool = False) -> None:
        """§A.4.3 — fixed-size array under partition (N_q)_{<P}.

        ``local_data``: the rank's N_p elements — one contiguous buffer, or
        a sequence of N_p element buffers when ``indirect`` is true (lists
        and tuples are auto-detected as indirect).
        """
        self._check_open()
        indirect = indirect or isinstance(local_data, (list, tuple))
        if len(counts) != self.comm.size:
            raise ScdaError(ScdaErrorCode.ARG_PARTITION,
                            f"{len(counts)} counts for {self.comm.size} ranks")
        N = sum(counts)
        if encode:
            elements = self._local_elements(local_data, counts, E, indirect)
            self.write_inline(
                codec.MAGIC_ARRAY,
                codec.uncompressed_size_entry(E, self.style)
                if self.comm.rank == 0 else None, 0)
            compressed = codec.compress_elements(elements, self.style)
            self._write_varray_raw(user_string, compressed, counts, N)
            return
        views, nbytes, last_byte = self._local_views(
            local_data, counts, E, indirect)
        frags: List[Frag] = []
        data_start = self._array_header_frags(frags, b"A", user_string, N, E)
        off, length = partition.byte_range(counts, E, self.comm.rank)
        if nbytes != length:
            raise ScdaError(ScdaErrorCode.ARG_DATA_SIZE,
                            f"local data {nbytes} != N_p*E {length}")
        pos = data_start + off
        for v in views:
            frags.append((pos, v))
            pos += len(v)
        self._append_padding(frags, data_start, N * E,
                             [c * E for c in counts], last_byte)
        self._backend.write_gather(frags)
        self.cursor = data_start + spec.padded_data_bytes(N * E)

    def write_array_windows(self, user_string: bytes,
                            windows: Sequence[Window],
                            N: int, E: int,
                            pad_last_byte: Optional[int] = None) -> None:
        """Generalized A-section write for non-contiguous ownership.

        The checkpoint layer uses this for 2-D-sharded tensors whose shards
        decompose into multiple contiguous runs of the canonical (row-major)
        element order.  ``windows`` are this rank's runs; collectively the
        runs must tile [0, N) exactly once.  ``pad_last_byte`` must be the
        value of the final data byte on the rank owning element N-1 (that
        rank writes the padding); pass None elsewhere.  This is a strict
        superset of :meth:`write_array` (which is the paper's contiguous
        case) and writes byte-identical files.

        Windows are written in ascending element order; adjacent windows
        coalesce into single vectored writes.
        """
        self._check_open()
        frags, next_cursor = self.plan_array_windows(
            user_string, windows, N, E, pad_last_byte, self.cursor)
        self._backend.write_gather(frags)
        self.cursor = next_cursor

    def plan_array_windows(self, user_string: bytes,
                           windows: Sequence[Window], N: int, E: int,
                           pad_last_byte: Optional[int] = None,
                           cursor: Optional[int] = None) \
            -> Tuple[List[Frag], int]:
        """This rank's :meth:`write_array_windows` fragments at ``cursor``
        — ``(frags, next_cursor)`` — without writing anything.

        The overlapped save engine's planning primitive: section offsets
        are fully determined by the collective parameters, so the
        scheduler plans every leaf's extents up front and emits the
        bodies out of order while the serial writer (which calls this
        exact method, then writes immediately) remains the byte oracle.
        """
        if cursor is None:
            cursor = self.cursor
        frags: List[Frag] = []
        data_start = self._array_header_frags(frags, b"A", user_string,
                                              N, E, cursor)
        owns_last = False
        for start, buf in sorted(windows, key=lambda w: w[0]):
            view = _as_bytes(buf)
            if len(view) % E:
                raise ScdaError(ScdaErrorCode.ARG_DATA_SIZE,
                                f"window not a multiple of E={E}")
            if start * E + len(view) > N * E:
                raise ScdaError(ScdaErrorCode.ARG_DATA_SIZE,
                                "window exceeds array extent")
            if len(view):
                frags.append((data_start + start * E, view))
                if start * E + len(view) == N * E:
                    owns_last = True
                    if pad_last_byte is None:
                        pad_last_byte = view[-1]
        n = N * E
        if owns_last:
            frags.append((data_start + n,
                          spec.pad_data(n, pad_last_byte, self.style)))
        elif n == 0 and self.comm.rank == 0:
            frags.append((data_start, spec.pad_data(0, None, self.style)))
        return frags, data_start + spec.padded_data_bytes(n)

    # ------------------------------------------------------------------ V --
    def write_varray(self, user_string: bytes,
                     local_data: Union[BytesLike, Sequence[BytesLike], None],
                     counts: Sequence[int],
                     local_sizes: Sequence[int],
                     per_rank_bytes: Optional[Sequence[int]] = None,
                     indirect: bool = False, encode: bool = False) -> None:
        """§A.4.4 — variable-size array.

        ``local_sizes`` are (E_i) for this rank's elements; ``per_rank_bytes``
        is the collective (S_q)_{<P} — per the paper we leave the allgather
        to the caller, but compute it if None is passed.  Lists/tuples are
        auto-detected as indirect addressing.
        """
        self._check_open()
        indirect = indirect or isinstance(local_data, (list, tuple))
        if len(counts) != self.comm.size:
            raise ScdaError(ScdaErrorCode.ARG_PARTITION,
                            f"{len(counts)} counts for {self.comm.size} ranks")
        if len(local_sizes) != counts[self.comm.rank]:
            raise ScdaError(ScdaErrorCode.ARG_PARTITION,
                            f"{len(local_sizes)} sizes != N_p "
                            f"{counts[self.comm.rank]}")
        elements = self._split(local_data, local_sizes, indirect)
        N = sum(counts)
        if encode:
            # §3.4 — A(magic, N, 32, U-entries) then V(user, compressed…).
            self._write_u_entry_array(counts, local_sizes, N)
            compressed = codec.compress_elements(
                [bytes(e) for e in elements], self.style)
            self._write_varray_raw(user_string, compressed, counts, N)
            return
        if per_rank_bytes is None:
            per_rank_bytes = self.comm.allgather(sum(local_sizes))
        self._write_varray_raw(user_string, elements, counts, N,
                               per_rank_bytes)

    def _write_varray_raw(self, user_string: bytes,
                          local_elements: Sequence[BytesLike],
                          counts: Sequence[int], N: int,
                          per_rank_bytes: Optional[Sequence[int]] = None) \
            -> None:
        """Shared raw-V writer (also the §3.3/§3.4 compressed-data carrier)."""
        local_views = [_as_bytes(e) for e in local_elements]
        local_sizes = [len(v) for v in local_views]
        if per_rank_bytes is None:
            per_rank_bytes = self.comm.allgather(sum(local_sizes))
        partition.validate(counts, N)
        offs = partition.offsets(counts)
        rank = self.comm.rank
        frags: List[Frag] = []
        entries_start = (self.cursor + spec.SECTION_HEADER_BYTES
                         + spec.COUNT_ENTRY_BYTES)
        data_start = entries_start + N * spec.COUNT_ENTRY_BYTES
        # Header built on every rank (collective argument validation),
        # enqueued only on rank 0.
        header = (spec.section_header(b"V", user_string, self.style),
                  spec.count_entry(b"N", N, self.style))
        if rank == 0:
            frags.append((self.cursor, header[0]))
            frags.append((self.cursor + spec.SECTION_HEADER_BYTES,
                          header[1]))
        # Each rank writes its own E_i entries (one vectorized buffer) …
        if counts[rank]:
            frags.append(
                (entries_start + offs[rank] * spec.COUNT_ENTRY_BYTES,
                 spec.count_entries(b"E", local_sizes, self.style,
                                    trusted_ints=True)))
        # … and its own data window, element views passed through untouched.
        my_off, my_len = partition.var_byte_ranges(
            counts, local_sizes, per_rank_bytes, rank)
        if my_len:
            pos = data_start + my_off
            last_local: Optional[int] = None
            for v in local_views:
                if len(v):
                    frags.append((pos, v))
                    pos += len(v)
                    last_local = v[-1]
        else:
            last_local = None
        total = sum(per_rank_bytes)
        self._append_varray_padding(frags, data_start, total, per_rank_bytes,
                                    last_local)
        self._backend.write_gather(frags)
        self.cursor = data_start + spec.padded_data_bytes(total)

    def plan_encoded_varray(self, user_string: bytes,
                            usizes: Sequence[int],
                            streams: Sequence[BytesLike],
                            cursor: Optional[int] = None) \
            -> Tuple[List[Frag], int]:
        """Single-rank planning mirror of ``write_varray(encode=True)``:
        the §3.4 A(U-entries) + V(compressed streams) section pair as
        ``(frags, next_cursor)``, nothing written.

        ``usizes`` are the uncompressed element sizes (the U entries —
        known from the layout before any byte deflates), ``streams`` the
        finished §3.1 streams.  The overlapped save engine calls this
        once a leaf's deflate futures resolve; byte-identity with the
        serial path holds because both build from the same
        :mod:`repro.core.encode` iovec oracles.
        """
        if self.comm.size != 1:
            raise ScdaError(ScdaErrorCode.ARG_PARTITION,
                            "encoded-varray planning is single-rank "
                            "(matching write_varray(encode=True) use)")
        if cursor is None:
            cursor = self.cursor
        frags: List[Frag] = []
        u_entries = spec.count_entries(b"U", list(usizes), self.style)
        for part in _encode.iov_array(
                codec.MAGIC_VARRAY, u_entries, len(usizes),
                spec.COUNT_ENTRY_BYTES, self.style):
            if len(part):
                frags.append((cursor, part))
            cursor += len(part)
        for part in _encode.iov_varray(user_string, streams, self.style):
            if len(part):
                frags.append((cursor, part))
            cursor += len(part)
        return frags, cursor

    def plan_varray(self, user_string: bytes,
                    elements: Sequence[BytesLike],
                    cursor: Optional[int] = None) \
            -> Tuple[List[Frag], int]:
        """Single-rank planning mirror of the raw ``write_varray`` path:
        one V section holding ``elements`` as ``(frags, next_cursor)``,
        nothing written.

        The delta-checkpoint placement uses this for the changed-chunk
        subset of an uncompressed leaf — the same role
        :meth:`plan_encoded_varray` plays for deflated chunks.  Byte
        identity with :meth:`write_varray` holds because both derive the
        entry table and padding from the same :mod:`repro.core.spec`
        arithmetic.
        """
        if self.comm.size != 1:
            raise ScdaError(ScdaErrorCode.ARG_PARTITION,
                            "varray planning is single-rank (matching the "
                            "delta placement's use)")
        if cursor is None:
            cursor = self.cursor
        views = [_as_bytes(e) for e in elements]
        sizes = [len(v) for v in views]
        N = len(views)
        frags: List[Frag] = []
        entries_start = (cursor + spec.SECTION_HEADER_BYTES
                         + spec.COUNT_ENTRY_BYTES)
        data_start = entries_start + N * spec.COUNT_ENTRY_BYTES
        frags.append((cursor,
                      spec.section_header(b"V", user_string, self.style)))
        frags.append((cursor + spec.SECTION_HEADER_BYTES,
                      spec.count_entry(b"N", N, self.style)))
        if N:
            frags.append((entries_start,
                          spec.count_entries(b"E", sizes, self.style,
                                             trusted_ints=True)))
        pos = data_start
        last: Optional[int] = None
        for v in views:
            if len(v):
                frags.append((pos, v))
                pos += len(v)
                last = v[-1]
        total = sum(sizes)
        frags.append((data_start + total,
                      spec.pad_data(total, last, self.style)))
        return frags, data_start + spec.padded_data_bytes(total)

    def _write_u_entry_array(self, counts: Sequence[int],
                             local_sizes: Sequence[int], N: int) -> None:
        """The A("V compressed scda 00", N, 32, U-entries) metadata section."""
        entries = spec.count_entries(b"U", local_sizes, self.style)
        view = memoryview(entries)
        self.write_array(
            codec.MAGIC_VARRAY,
            [view[i * spec.COUNT_ENTRY_BYTES:(i + 1) * spec.COUNT_ENTRY_BYTES]
             for i in range(len(local_sizes))],
            counts, spec.COUNT_ENTRY_BYTES, indirect=True)

    # -- shared helpers -------------------------------------------------------
    def _array_header_frags(self, frags: List[Frag], letter: bytes,
                            user_string: bytes, N: int, E: int,
                            cursor: Optional[int] = None) -> int:
        """Build the A-section header entries and return data_start.

        The entries are constructed on *every* rank so argument validation
        stays collective (all ranks raise together, none runs ahead into a
        diverged file state); only rank 0 enqueues them for writing.
        """
        if cursor is None:
            cursor = self.cursor
        header = (spec.section_header(letter, user_string, self.style),
                  spec.count_entry(b"N", N, self.style),
                  spec.count_entry(b"E", E, self.style))
        if self.comm.rank == 0:
            frags.append((cursor, header[0]))
            frags.append((cursor + spec.SECTION_HEADER_BYTES, header[1]))
            frags.append((cursor + spec.SECTION_HEADER_BYTES
                          + spec.COUNT_ENTRY_BYTES, header[2]))
        return (cursor + spec.SECTION_HEADER_BYTES
                + 2 * spec.COUNT_ENTRY_BYTES)

    def _append_padding(self, frags: List[Frag], data_start: int, n: int,
                        rank_bytes: Sequence[int],
                        last_byte: Optional[int]) -> None:
        last_rank = partition.last_nonempty_rank(rank_bytes)
        if last_rank < 0:
            if self.comm.rank == 0:
                frags.append((data_start,
                              spec.pad_data(0, None, self.style)))
        elif self.comm.rank == last_rank:
            frags.append((data_start + n,
                          spec.pad_data(n, last_byte, self.style)))

    def _append_varray_padding(self, frags: List[Frag], data_start: int,
                               total: int, per_rank_bytes: Sequence[int],
                               last_local: Optional[int]) -> None:
        last_rank = partition.last_nonempty_rank(per_rank_bytes)
        if last_rank < 0:
            if self.comm.rank == 0:
                frags.append((data_start,
                              spec.pad_data(0, None, self.style)))
        elif self.comm.rank == last_rank:
            frags.append((data_start + total,
                          spec.pad_data(total, last_local, self.style)))

    def _local_views(self, local_data, counts, E, indirect) \
            -> Tuple[List[memoryview], int, Optional[int]]:
        """This rank's data as a list of views: (views, nbytes, last_byte).

        Zero-copy: indirect element buffers stay separate fragments of one
        gathered write instead of being joined.
        """
        if indirect:
            elems = [_as_bytes(e) for e in (local_data or [])]
            if len(elems) != counts[self.comm.rank]:
                raise ScdaError(ScdaErrorCode.ARG_PARTITION,
                                f"{len(elems)} buffers != N_p")
            for e in elems:
                if len(e) != E:
                    raise ScdaError(ScdaErrorCode.ARG_DATA_SIZE,
                                    f"element is {len(e)} bytes, E={E}")
            nbytes = E * len(elems)
            last = elems[-1][-1] if elems and E else None
            return elems, nbytes, last
        view = _as_bytes(local_data if local_data is not None else b"")
        if len(view) == 0:
            return [], 0, None
        return [view], len(view), view[-1]

    def _local_elements(self, local_data, counts, E, indirect) -> List[bytes]:
        views, nbytes, _ = self._local_views(local_data, counts, E, indirect)
        np_ = counts[self.comm.rank]
        if nbytes != np_ * E:
            raise ScdaError(ScdaErrorCode.ARG_DATA_SIZE,
                            f"local data {nbytes} != N_p*E {np_ * E}")
        if indirect:
            return [bytes(v) for v in views]
        flat = views[0] if views else memoryview(b"")
        return [bytes(flat[i * E:(i + 1) * E]) for i in range(np_)]

    def _split(self, local_data, local_sizes, indirect) -> List[memoryview]:
        if indirect:
            elems = [_as_bytes(e) for e in (local_data or [])]
            if [len(e) for e in elems] != list(local_sizes):
                raise ScdaError(ScdaErrorCode.ARG_DATA_SIZE,
                                "indirect buffer sizes != local_sizes")
            return elems
        flat = _as_bytes(local_data if local_data is not None else b"")
        if len(flat) != sum(local_sizes):
            raise ScdaError(ScdaErrorCode.ARG_DATA_SIZE,
                            f"flat data {len(flat)} != Σ sizes "
                            f"{sum(local_sizes)}")
        out, pos = [], 0
        for s in local_sizes:
            out.append(flat[pos:pos + s])
            pos += s
        return out

    def _check_open(self) -> None:
        if self._closed:
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE, "writer is closed")

    def close(self, sync: Optional[bool] = None) -> None:
        """Collective close (§A.3.2).

        With ``sync`` (argument > constructor default > REPRO_SCDA_FSYNC)
        every rank fsyncs its descriptor after the final barrier — on a
        parallel file system each client must flush its own cache, so a
        single-rank fsync would not be durable multi-host.
        """
        if self._closed:
            return
        sync = self.sync if sync is None else sync
        # Quiesce BEFORE the barrier: with the overlapped save engine a
        # rank may still have queued background writes, and the final
        # barrier's contract is "all data is on its way to the kernel on
        # every rank" — a reader on another rank may open the file the
        # moment its own close returns.  A failed background write must
        # not leak the descriptor or skip the barriers (the other ranks
        # are waiting); it is re-raised once the close is complete.
        err: Optional[ScdaError] = None
        try:
            self._backend.drain_writes()
        except ScdaError as e:
            err = e
        self.comm.barrier()
        self._backend.close(sync=sync and err is None)
        self._closed = True
        self.comm.barrier()
        if err is not None:
            raise err


def fopen_write(comm: Optional[Communicator], path: str,
                user_string: bytes = b"", vendor: bytes = DEFAULT_VENDOR,
                style: str = spec.UNIX,
                sync: Optional[bool] = None) -> ScdaWriter:
    """``scda_fopen(..., 'w')`` — collective create/overwrite."""
    return ScdaWriter(comm or SerialComm(), path, user_string, vendor, style,
                      sync=sync)


def fopen_append(comm: Optional[Communicator], path: str,
                 sync: Optional[bool] = None,
                 recover: bool = False) -> ScdaWriter:
    """``scda_fopen(..., 'a')`` — collective append to an existing archive.

    The file's tail is validated first (magic, the last section's header,
    count entries, and extent/padding arithmetic; a fresh ``.scdax``
    sidecar makes this O(last section) instead of a full header walk) and
    the cursor resumes exactly where a single longer serial session would
    stand.  New sections then go through the identical planner/iovec fast
    path, so the grown file is byte-for-byte what one session writing all
    sections would have produced — under *any* appending partition.

    Vendor, user string, line-break style, and format version are
    inherited from the existing file header (they are already on disk).
    A truncated or garbage tail raises the reader's CORRUPT_* error with
    the failing byte offset; ``recover=True`` instead truncates a torn
    tail back to the last valid section boundary (never past the file
    header) before appending — the journal's self-healing mode.
    """
    return ScdaWriter(comm or SerialComm(), path, sync=sync, mode="a",
                      recover=recover)
