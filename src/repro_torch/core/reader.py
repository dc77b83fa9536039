"""Parallel scda reader (paper §A.5).

The file is consumed one section at a time: ``read_section_header`` first
(optionally interpreting the §3 compression convention, Table 2), then the
matching data call with a *reading partition chosen freely* — independence
of the writing partition is the point of the format.

Every rank parses section metadata from its own positioned reads of the
(identical) file bytes, which synchronizes collective outputs without
message traffic; only variable-size bookkeeping (per-rank byte sums) uses an
allgather.  Headers are tiny, so O(P) redundant metadata reads are the
standard scalable pattern on parallel file systems.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.core import codec, partition, spec
from repro_torch.core.comm import Communicator, SerialComm
from repro_torch.core.errors import ScdaError, ScdaErrorCode
from repro_torch.core.io_backend import FileBackend


@dataclasses.dataclass
class SectionHeader:
    """Logical header returned by :meth:`ScdaReader.read_section_header`.

    ``type`` ∈ {'I','B','A','V'}; for decoded sections the *logical* type and
    sizes are reported (paper Table 2): e.g. a compressed fixed-size array
    reads back as type 'A' with E = the uncompressed element size.
    """
    type: str
    user_string: bytes
    N: int = 0
    E: int = 0
    decoded: bool = False


@dataclasses.dataclass
class _Pending:
    """Cursor state between the header call and the data call(s)."""
    kind: str                   # 'I' | 'B' | 'A' | 'V' | 'zB' | 'zA' | 'zV'
    header: Optional[SectionHeader] = None
    data_start: int = 0         # raw payload start
    entries_start: int = 0      # V: E_i entries;  zV: U entries of the A
    v_entries_start: int = 0    # zA/zV: E_i entries of the carrier V
    v_data_start: int = 0       # zA/zV: compressed payload start
    raw_E: int = 0              # zB: compressed block size
    sizes_read: bool = False
    total_bytes: Optional[int] = None  # V/zX: Σ data bytes once known


class ScdaReader:
    """File context for mode 'r' (§A.3); forward-only cursor."""

    def __init__(self, comm: Optional[Communicator], path: str,
                 backend: Optional[FileBackend] = None) -> None:
        self.comm = comm or SerialComm()
        self.path = path
        # ``backend`` lets a caller substitute a synthetic byte source —
        # the degraded-mode reconstructor in repro.checkpoint.redundancy
        # reads a lost shard's bytes out of surviving shards + parity.
        self._backend = (backend if backend is not None
                         else FileBackend(path, "r", create=False))
        self._closed = False
        self._pending: Optional[_Pending] = None
        self._index = None  # lazy ScdaIndex (see repro.core.index)
        header = spec.parse_file_header(
            self._backend.pread(0, spec.FILE_HEADER_BYTES))
        self.version = header.version
        self.vendor = header.vendor
        self.user_string = header.user_string
        self.cursor = spec.FILE_HEADER_BYTES
        self._file_size = self._backend.size()

    def __enter__(self) -> "ScdaReader":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    @property
    def at_eof(self) -> bool:
        return self._pending is None and self.cursor >= self._file_size

    # -- parse helpers carrying exact offsets ---------------------------------
    def _header_at(self, off: int):
        """Parse the 64-byte section header at ``off``; a parse failure
        carries the exact byte offset (``ScdaError.offset``) so fsck and
        mode-'a' tail validation can point at the failing byte."""
        try:
            return spec.parse_section_header(
                self._backend.pread(off, spec.SECTION_HEADER_BYTES))
        except ScdaError as e:
            raise e.at(off)

    def _entry_at(self, off: int, letter: bytes) -> int:
        """Parse the 32-byte count entry at ``off``, offset-attributed."""
        try:
            return spec.parse_count_entry(
                self._backend.pread(off, spec.COUNT_ENTRY_BYTES), letter)
        except ScdaError as e:
            raise e.at(off)

    # -- section header (§A.5.1) --------------------------------------------
    def read_section_header(self, decode: bool = True) -> SectionHeader:
        self._check_open()
        if self._pending is not None:
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                            "previous section's data not consumed")
        if self.at_eof:
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE, "at end of file")
        letter, user = self._header_at(self.cursor)
        t = letter.decode("ascii")
        if letter not in spec.SECTION_TYPES:
            raise ScdaError(ScdaErrorCode.CORRUPT_SECTION_TYPE, repr(letter),
                            offset=self.cursor)
        if decode and letter == b"I" and user in (codec.MAGIC_BLOCK,
                                                  codec.MAGIC_ARRAY):
            return self._begin_decoded_inline(user)
        if decode and letter == b"A" and user == codec.MAGIC_VARRAY:
            return self._begin_decoded_varray()
        return self._begin_raw(t, user)

    def _begin_raw(self, t: str, user: bytes) -> SectionHeader:
        cur = self.cursor + spec.SECTION_HEADER_BYTES
        if t == "I":
            hdr = SectionHeader("I", user)
            self._pending = _Pending("I", hdr, data_start=cur)
        elif t == "B":
            E = self._entry_at(cur, b"E")
            hdr = SectionHeader("B", user, E=E)
            self._pending = _Pending(
                "B", hdr, data_start=cur + spec.COUNT_ENTRY_BYTES)
        elif t == "A":
            N = self._entry_at(cur, b"N")
            E = self._entry_at(cur + spec.COUNT_ENTRY_BYTES, b"E")
            hdr = SectionHeader("A", user, N=N, E=E)
            self._pending = _Pending(
                "A", hdr, data_start=cur + 2 * spec.COUNT_ENTRY_BYTES)
        else:  # V
            N = self._entry_at(cur, b"N")
            hdr = SectionHeader("V", user, N=N)
            entries = cur + spec.COUNT_ENTRY_BYTES
            self._pending = _Pending(
                "V", hdr, entries_start=entries,
                data_start=entries + N * spec.COUNT_ENTRY_BYTES)
        return self._pending.header

    def _begin_decoded_inline(self, magic: bytes) -> SectionHeader:
        """§3.2/§3.3 — I(magic, U) followed by B or V with the true header."""
        udata = self._backend.pread(
            self.cursor + spec.SECTION_HEADER_BYTES, spec.INLINE_DATA_BYTES)
        U = codec.parse_uncompressed_size_entry(udata)
        second = self.cursor + spec.INLINE_SECTION_BYTES
        letter, user = self._header_at(second)
        cur = second + spec.SECTION_HEADER_BYTES
        if magic == codec.MAGIC_BLOCK:
            if letter != b"B":
                raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                                f"expected B after {magic!r}, got {letter!r}",
                                offset=second)
            cE = self._entry_at(cur, b"E")
            hdr = SectionHeader("B", user, E=U, decoded=True)
            self._pending = _Pending(
                "zB", hdr, data_start=cur + spec.COUNT_ENTRY_BYTES, raw_E=cE)
        else:  # MAGIC_ARRAY → logical fixed-size array carried by a V
            if letter != b"V":
                raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                                f"expected V after {magic!r}, got {letter!r}",
                                offset=second)
            N = self._entry_at(cur, b"N")
            hdr = SectionHeader("A", user, N=N, E=U, decoded=True)
            entries = cur + spec.COUNT_ENTRY_BYTES
            self._pending = _Pending(
                "zA", hdr, v_entries_start=entries,
                v_data_start=entries + N * spec.COUNT_ENTRY_BYTES)
        return self._pending.header

    def _begin_decoded_varray(self) -> SectionHeader:
        """§3.4 — A(magic, N, 32, U-entries) followed by the carrier V."""
        cur = self.cursor + spec.SECTION_HEADER_BYTES
        N = self._entry_at(cur, b"N")
        E = self._entry_at(cur + spec.COUNT_ENTRY_BYTES, b"E")
        if E != spec.COUNT_ENTRY_BYTES:
            raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                            f"U-entry array has E={E}, expected 32",
                            offset=cur + spec.COUNT_ENTRY_BYTES)
        u_entries = cur + 2 * spec.COUNT_ENTRY_BYTES
        second = u_entries + spec.padded_data_bytes(
            N * spec.COUNT_ENTRY_BYTES)
        letter, user = self._header_at(second)
        if letter != b"V":
            raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                            f"expected V after U-entry array, got {letter!r}",
                            offset=second)
        vcur = second + spec.SECTION_HEADER_BYTES
        vN = self._entry_at(vcur, b"N")
        if vN != N:
            raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                            f"carrier V has N={vN}, metadata says {N}",
                            offset=vcur)
        hdr = SectionHeader("V", user, N=N, decoded=True)
        v_entries = vcur + spec.COUNT_ENTRY_BYTES
        self._pending = _Pending(
            "zV", hdr, entries_start=u_entries,
            v_entries_start=v_entries,
            v_data_start=v_entries + N * spec.COUNT_ENTRY_BYTES)
        return self._pending.header

    # -- random access (§1: selective access; the PR-2 index layer) -----------
    def index(self, rebuild: bool = False):
        """The file's :class:`~repro.core.index.ScdaIndex`, built lazily.

        Building is one header-only scan (rank-local; every rank sees the
        identical bytes, so no collective traffic is needed).  Pass a
        pre-built/sidecar-loaded index via :meth:`set_index` to skip even
        that.  The cursor and any pending section are preserved (also when
        the build fails on a corrupt file), so calling this mid-walk is
        safe and seek-after-browse behaves the same with or without a
        cached index.
        """
        if self._index is None or rebuild:
            from repro_torch.core.index import ScdaIndex
            saved_cursor, saved_pending = self.cursor, self._pending
            self._pending = None
            try:
                self._index = ScdaIndex.build(self)
            finally:
                self.cursor, self._pending = saved_cursor, saved_pending
        return self._index

    def set_index(self, index) -> None:
        """Adopt a pre-built index (e.g. loaded from a ``.scdax`` sidecar)."""
        self._index = index

    def seek_section(self, i: int, check: bool = True) -> SectionHeader:
        """Jump straight to logical section ``i`` (random access).

        Positions the cursor on the section and installs the same pending
        state a forward :meth:`read_section_header` walk would have produced,
        without replaying the file — any data call (windowed/element reads
        included) works afterwards.  Discards any currently pending section.

        ``check`` re-reads the 64-byte on-disk section header and verifies
        it against the index entry, so a stale sidecar can never silently
        return wrong bytes.  Non-collective: any rank may seek freely, but
        collective data calls still require all ranks on the same section.
        """
        self._check_open()
        idx = self.index()
        entries = idx.entries
        if not 0 <= i < len(entries):
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                            f"section {i} outside [0, {len(entries)})")
        e = entries[i]
        if check:
            # Seek-aware readahead: a jump outside the current window
            # drops and re-fits it at the target, so the header check
            # below and the metadata reads that follow are warm.  Skipped
            # for check=False, which promises an I/O-free seek.
            self._backend.refit_readahead(e.start)
            self.verify_index_entry(i, e)
        self._backend.advise(e.start, e.end - e.start, "willneed")
        self.cursor = e.start
        self._pending = e.to_pending()
        return self._pending.header

    def verify_index_entry(self, i: int, entry=None) -> None:
        """Re-read section ``i``'s on-disk 64-byte header and require it to
        match the index entry — the per-use staleness check every
        index-driven access path (seek, batch read, restore engine) runs
        so a stale sidecar can never silently return wrong bytes."""
        e = self.index().entries[i] if entry is None else entry
        raw_letter, raw_user = e.raw_header()
        letter, user = spec.parse_section_header(
            self._backend.pread(e.start, spec.SECTION_HEADER_BYTES))
        if letter != raw_letter or user != raw_user:
            raise ScdaError(
                ScdaErrorCode.CORRUPT_ENCODING,
                f"index entry {i} does not match the file at offset "
                f"{e.start}: expected {raw_letter!r} {raw_user!r}, "
                f"found {letter!r} {user!r} (stale index?)")

    def open_section(self, user_string: bytes, occurrence: int = 0,
                     check: bool = True) -> SectionHeader:
        """Seek to the ``occurrence``-th section whose user string matches."""
        i = self.index().find(user_string, occurrence)
        if i < 0:
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                            f"no section with user string {user_string!r} "
                            f"(occurrence {occurrence})")
        return self.seek_section(i, check=check)

    # -- data reads (§A.5.2–A.5.6) -------------------------------------------
    def read_inline_data(self, root: Optional[int] = None) -> Optional[bytes]:
        """§A.5.2.  ``root=None`` returns the bytes on every rank."""
        p = self._require("I")
        out: Optional[bytes] = None
        if root is None or self.comm.rank == root:
            out = self._backend.pread(p.data_start, spec.INLINE_DATA_BYTES)
        self._finish(p.data_start + spec.INLINE_DATA_BYTES)
        return out

    def read_block_data(self, N: Optional[int] = None,
                        root: Optional[int] = None) -> Optional[bytes]:
        """§A.5.3.  ``N`` must match the header if given (call-consistency)."""
        p = self._require("B", "zB")
        hdr = p.header
        if N is not None and N != hdr.E:
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                            f"N={N} inconsistent with header E={hdr.E}")
        raw_len = p.raw_E if p.kind == "zB" else hdr.E
        out: Optional[bytes] = None
        if root is None or self.comm.rank == root:
            raw = self._backend.pread(p.data_start, raw_len)
            if p.kind == "zB":
                raw = codec.decompress(raw)
                if len(raw) != hdr.E:
                    raise ScdaError(ScdaErrorCode.CORRUPT_CHECKSUM,
                                    f"block inflated to {len(raw)}, "
                                    f"metadata says {hdr.E}")
            out = raw
        self._finish(p.data_start + spec.padded_data_bytes(raw_len))
        return out

    def skip_data(self) -> None:
        """Advance past the current section without touching its payload.

        Enables the paper's "query function [that] reads all file section
        headers but skips the data bytes" (§A.5.1).
        """
        p = self._pending
        if p is None:
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE, "no pending section")
        if p.kind == "I":
            p.total_bytes = spec.INLINE_DATA_BYTES
            end = p.data_start + spec.INLINE_DATA_BYTES
        elif p.kind == "B":
            p.total_bytes = p.header.E
            end = p.data_start + spec.padded_data_bytes(p.header.E)
        elif p.kind == "zB":
            p.total_bytes = p.raw_E
            end = p.data_start + spec.padded_data_bytes(p.raw_E)
        elif p.kind == "A":
            p.total_bytes = p.header.N * p.header.E
            end = p.data_start + spec.padded_data_bytes(p.total_bytes)
        else:  # V, zA, zV — must sum the carrier's element sizes
            N = p.header.N
            entries_start = (p.entries_start if p.kind == "V"
                             else p.v_entries_start)
            data_start = (p.data_start if p.kind == "V" else p.v_data_start)
            total = self._sum_entries(entries_start, N)
            p.total_bytes = total
            end = data_start + spec.padded_data_bytes(total)
        self._finish(end)

    def read_array_data(self, counts: Sequence[int], E: Optional[int] = None,
                        indirect: bool = False) -> Optional[List[bytes]]:
        """§A.5.4 — each rank receives its N_p elements of E bytes.

        Returns a list of element buffers (the ``indirect`` view); callers
        wanting one flat buffer join them.  Works for both raw 'A' sections
        and §3.3-encoded ones (transparent decompression).
        """
        p = self._require("A", "zA")
        hdr = p.header
        partition.validate(counts, hdr.N)
        if E is not None and E != hdr.E:
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                            f"E={E} inconsistent with header E={hdr.E}")
        rank = self.comm.rank
        if p.kind == "A":
            off, length = partition.byte_range(counts, hdr.E, rank)
            flat = self._backend.pread(p.data_start + off, length) \
                if length else b""
            out = [flat[i * hdr.E:(i + 1) * hdr.E]
                   for i in range(counts[rank])]
            self._finish(p.data_start
                         + spec.padded_data_bytes(hdr.N * hdr.E))
            return out
        # zA: compressed elements ride a V section; all elements must
        # inflate to exactly E bytes.
        elements, end = self._read_v_elements(
            counts, p.v_entries_start, p.v_data_start, hdr.N)
        out = []
        for e in elements:
            raw = codec.decompress(e)
            if len(raw) != hdr.E:
                raise ScdaError(ScdaErrorCode.CORRUPT_CHECKSUM,
                                f"element inflated to {len(raw)}, "
                                f"expected E={hdr.E}")
            out.append(raw)
        self._finish(end)
        return out

    def read_array_windows(self, windows: Sequence, E: int) -> List[bytes]:
        """Selective random access: read arbitrary element ranges.

        ``windows`` = [(elem_start, n_elems), ...].  Raw 'A' sections only —
        this is the selective-access capability §1 motivates; the checkpoint
        layer uses it to assemble arbitrary target shards.  Does not advance
        the cursor (call :meth:`skip_data` when done with the section).
        """
        p = self._pending
        if p is None or p.kind != "A":
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                            "windowed reads need a pending raw A section")
        if E != p.header.E:
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE, "E mismatch")
        out = []
        for start, n in windows:
            if start < 0 or start + n > p.header.N:
                raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                                "window outside array")
            out.append(self._backend.pread(p.data_start + start * E, n * E))
        return out

    def read_varray_elements(self, indices: Sequence[int]) -> List[bytes]:
        """Selective random access to individual varray elements (§1).

        Works on raw 'V' and decoded 'zV' sections; decompresses decoded
        elements transparently.  Reads the size-entry table rank-locally to
        locate elements, then preads exactly the requested payloads.  Does
        not advance the cursor — finish the section with :meth:`skip_data`
        (or a full data read).
        """
        p = self._pending
        if p is None or p.kind not in ("V", "zV"):
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                            "element reads need a pending V section")
        N = p.header.N
        for i in indices:
            if not 0 <= i < N:
                raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                                f"element {i} outside [0, {N})")
        if p.kind == "V":
            entries_start, data_start = p.entries_start, p.data_start
        else:
            entries_start, data_start = p.v_entries_start, p.v_data_start
        sizes = self._parse_entries(entries_start, 0, N, b"E")
        offs = partition.offsets(sizes)
        out = []
        for i in indices:
            raw = self._backend.pread(data_start + offs[i], sizes[i]) \
                if sizes[i] else b""
            if p.kind == "zV":
                expect = self._parse_entries(p.entries_start, i, 1, b"U")[0]
                raw = codec.decompress(raw)
                if len(raw) != expect:
                    raise ScdaError(ScdaErrorCode.CORRUPT_CHECKSUM,
                                    f"element {i} inflated to {len(raw)}, "
                                    f"U-entry says {expect}")
            out.append(raw)
        return out

    def read_batch(self, requests: Sequence, prefetch_bytes: Optional[int]
                   = None):
        """Batched, pipelined element reads across sections (§1 selective
        access at archive scale — the overlapped restore engine's API).

        ``requests``: sequence of ``(section_index, windows)`` where
        ``windows`` is a list of ``(elem_start, n_elems)`` element windows.
        Supported section kinds: fixed arrays ('A', 'zA') and varrays
        ('V', 'zV'); §3-encoded elements are transparently inflated (on
        the codec thread pool when the pipeline is live).

        Returns an iterator of ``(request_pos, results)`` yielded as each
        request completes — requests are processed in FILE-OFFSET order,
        not argument order, so disk consumption sweeps forward while
        decompression overlaps on the pool.  ``results``: for 'A'/'zA' one
        buffer per window (elements joined); for 'V'/'zV' one ``bytes``
        per element, in window order.

        ``prefetch_bytes=None`` uses ``REPRO_SCDA_PREFETCH`` (default
        4 MiB); ``0`` disables the background pipeline and reads serially
        in the given order — byte-identical either way.  Non-collective
        and cursor-neutral: any rank may batch-read any sections without
        disturbing a pending section or the forward walk; every section's
        on-disk header is re-checked against the index, as in
        :meth:`seek_section`.
        """
        from repro_torch.core.io_backend import prefetch_window
        from repro_torch.core.pipeline import ReadItem, run_pipeline
        self._check_open()
        if prefetch_bytes is None:
            prefetch_bytes = prefetch_window()
        entries = self.index().entries
        checked = set()
        requests = [(sec, list(windows)) for sec, windows in requests]
        # One count-entry parse per (section, letter), to the furthest
        # element any request touches — windowed callers (scdatool diff
        # walks a section in ~1 MiB slices) would otherwise re-parse a
        # growing prefix per window, quadratic in section size.
        max_upto: dict = {}
        for sec, windows in requests:
            upto = max((s + n for s, n in windows), default=0)
            max_upto[sec] = max(max_upto.get(sec, 0), upto)
        tables: dict = {}  # (section, letter) -> parsed count entries

        def _table(sec, start, letter):
            key = (sec, letter)
            if key not in tables:
                tables[key] = self._parse_entries(start, 0, max_upto[sec],
                                                  letter)
            return tables[key]

        items: List = []
        posts: dict = {}
        for pos, (sec, windows) in enumerate(requests):
            if not 0 <= sec < len(entries):
                raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                                f"section {sec} outside [0, {len(entries)})")
            e = entries[sec]
            if sec not in checked:
                self.verify_index_entry(sec, e)
                checked.add(sec)
            for s, n in windows:
                if s < 0 or n < 0 or s + n > e.N:
                    raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                                    f"window ({s}, {n}) outside section "
                                    f"{sec}'s [0, {e.N})")
            flat = [i for s, n in windows for i in range(s, s + n)]
            if e.kind == "A":
                extents = [(e.data_start + s * e.E, n * e.E)
                           for s, n in windows]
                items.append(ReadItem(pos, extents))
                posts[pos] = ("windows", None)
            elif e.kind == "zA":
                csizes = _table(sec, e.v_entries_start, b"E")
                offs = partition.offsets(csizes)
                extents = [(e.v_data_start + offs[i], csizes[i])
                           for i in flat]
                items.append(ReadItem(pos, extents, inflate=True,
                                      expected_sizes=[e.E] * len(flat)))
                posts[pos] = ("join", [n for _, n in windows])
            elif e.kind == "V":
                sizes = _table(sec, e.entries_start, b"E")
                offs = partition.offsets(sizes)
                extents = [(e.data_start + offs[s],
                            offs[s + n] - offs[s]) for s, n in windows]
                items.append(ReadItem(pos, extents))
                posts[pos] = ("split", [sizes[s:s + n] for s, n in windows])
            elif e.kind == "zV":
                csizes = _table(sec, e.v_entries_start, b"E")
                usizes = _table(sec, e.entries_start, b"U")
                offs = partition.offsets(csizes)
                extents = [(e.v_data_start + offs[i], csizes[i])
                           for i in flat]
                items.append(ReadItem(pos, extents, inflate=True,
                                      expected_sizes=[usizes[i]
                                                      for i in flat]))
                posts[pos] = ("elements", None)
            else:
                raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                                f"read_batch needs an array or varray "
                                f"section; section {sec} is {e.kind!r}")
        items.sort(key=lambda it: it.start())

        def _assemble():
            for key, res in run_pipeline(self._backend, items,
                                         prefetch_bytes):
                mode, meta = posts[key]
                if mode == "join":
                    out, it = [], iter(res)
                    for n in meta:
                        out.append(b"".join(
                            next(it) for _ in range(n)))
                elif mode == "split":
                    out = []
                    for buf, sizes in zip(res, meta):
                        view, p = memoryview(buf), 0
                        for s in sizes:
                            out.append(bytes(view[p:p + s]))
                            p += s
                else:  # "windows" / "elements" — engine results verbatim
                    out = [bytes(b) if not isinstance(b, bytes) else b
                           for b in res]
                yield key, out
        return _assemble()

    def read_varray_sizes(self, counts: Sequence[int]) -> List[int]:
        """§A.5.5 — this rank's (E_i); for decoded sections these are the
        *uncompressed* sizes (from the §3.4 U-entry array)."""
        p = self._require("V", "zV", keep=True)
        partition.validate(counts, p.header.N)
        offs = partition.offsets(counts)
        rank = self.comm.rank
        if p.kind == "V":
            sizes = self._parse_entries(
                p.entries_start, offs[rank], counts[rank], b"E")
        else:  # zV — uncompressed sizes live in the metadata A section
            sizes = self._parse_entries(
                p.entries_start, offs[rank], counts[rank], b"U")
        p.sizes_read = True
        return sizes

    def read_varray_data(self, counts: Sequence[int],
                         local_sizes: Sequence[int],
                         per_rank_bytes: Optional[Sequence[int]] = None,
                         indirect: bool = False) -> List[bytes]:
        """§A.5.6 — this rank's elements under the reading partition."""
        p = self._require("V", "zV")
        hdr = p.header
        partition.validate(counts, hdr.N)
        if len(local_sizes) != counts[self.comm.rank]:
            raise ScdaError(ScdaErrorCode.ARG_PARTITION,
                            "local_sizes length != N_p")
        if p.kind == "V":
            if per_rank_bytes is None:
                per_rank_bytes = self.comm.allgather(sum(local_sizes))
            off, length = partition.var_byte_ranges(
                counts, local_sizes, per_rank_bytes, self.comm.rank)
            flat = self._backend.pread(p.data_start + off, length) \
                if length else b""
            out, pos = [], 0
            for s in local_sizes:
                out.append(flat[pos:pos + s])
                pos += s
            total = sum(per_rank_bytes)
            self._finish(p.data_start + spec.padded_data_bytes(total))
            return out
        # zV: read compressed elements from the carrier V, inflate, check
        # against the uncompressed sizes the caller got from
        # read_varray_sizes.
        elements, end = self._read_v_elements(
            counts, p.v_entries_start, p.v_data_start, hdr.N)
        out = []
        for e, expect in zip(elements, local_sizes):
            raw = codec.decompress(e)
            if len(raw) != expect:
                raise ScdaError(ScdaErrorCode.CORRUPT_CHECKSUM,
                                f"element inflated to {len(raw)}, "
                                f"U-entry says {expect}")
            out.append(raw)
        self._finish(end)
        return out

    # -- internals -------------------------------------------------------------
    def _read_v_elements(self, counts, entries_start, data_start, N):
        """Read this rank's compressed elements of a carrier V section."""
        offs = partition.offsets(counts)
        rank = self.comm.rank
        csizes = self._parse_entries(
            entries_start, offs[rank], counts[rank], b"E")
        local_total = sum(csizes)
        per_rank = self.comm.allgather(local_total)
        start = sum(per_rank[:rank])
        flat = self._backend.pread(data_start + start, local_total) \
            if local_total else b""
        out, pos = [], 0
        for s in csizes:
            out.append(flat[pos:pos + s])
            pos += s
        total = sum(per_rank)
        return out, data_start + spec.padded_data_bytes(total)

    def _parse_entries(self, entries_start: int, first: int, n: int,
                       letter: Optional[bytes]) -> List[int]:
        """One buffered read + vectorized batch parse of n count entries.

        A malformed entry's error carries the exact 32-byte-entry offset:
        the batch parser reports only that *some* entry failed, so the
        scalar oracle re-locates the first bad one.
        """
        if n == 0:
            return []
        start = entries_start + first * spec.COUNT_ENTRY_BYTES
        raw = self._backend.pread(start, n * spec.COUNT_ENTRY_BYTES)
        try:
            return spec.parse_count_entries(raw, letter, n)
        except ScdaError as e:
            if e.offset is None:
                for i in range(n):
                    entry = raw[i * spec.COUNT_ENTRY_BYTES:
                                (i + 1) * spec.COUNT_ENTRY_BYTES]
                    try:
                        spec.parse_count_entry(
                            entry, entry[0:1] if letter is None else letter)
                    except ScdaError:
                        e.offset = start + i * spec.COUNT_ENTRY_BYTES
                        break
            raise

    def _sum_entries(self, entries_start: int, N: int,
                     chunk: int = 8192) -> int:
        """Rank-local sum of all N count entries (for skip paths)."""
        total = 0
        for first in range(0, N, chunk):
            n = min(chunk, N - first)
            # letter=None: accept each entry's own letter, as the lenient
            # skip path always has.
            total += sum(self._parse_entries(entries_start, first, n, None))
        return total

    def _require(self, *kinds: str, keep: bool = False) -> _Pending:
        self._check_open()
        p = self._pending
        if p is None or p.kind not in kinds:
            have = "none" if p is None else p.kind
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                            f"expected pending {kinds}, have {have}")
        if p.kind in ("V", "zV") and not keep and not p.sizes_read:
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                            "read_varray_sizes must precede varray data")
        return p

    def _finish(self, new_cursor: int) -> None:
        if new_cursor > self._file_size:
            raise ScdaError(ScdaErrorCode.CORRUPT_TRUNCATED,
                            f"section extends to {new_cursor}, file is "
                            f"{self._file_size} bytes",
                            offset=self._file_size)
        self.cursor = new_cursor
        self._pending = None

    def _check_open(self) -> None:
        if self._closed:
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE, "reader is closed")

    def close(self) -> None:
        if self._closed:
            return
        self._backend.close()
        self._closed = True


def fopen_read(comm: Optional[Communicator], path: str) -> ScdaReader:
    """``scda_fopen(..., 'r')`` — collective open for reading."""
    return ScdaReader(comm, path)


def scan_sections(path: str, decode: bool = True,
                  comm: Optional[Communicator] = None) -> List[SectionHeader]:
    """Walk every section header, skipping payloads.

    Collective over ``comm`` when one is passed (each rank performs the
    identical rank-local metadata walk, as in §A.5.1); defaults to serial.
    """
    headers: List[SectionHeader] = []
    with fopen_read(comm or SerialComm(), path) as r:
        while not r.at_eof:
            headers.append(r.read_section_header(decode=decode))
            r.skip_data()
    return headers
