"""Seekable section index — the random-access layer over the scda stream.

The paper motivates scda for "generic and flexible archival and
checkpoint/restart" with selective access (§1), but the on-disk stream has
no record table: locating section i requires walking all i-1 predecessors.
:class:`ScdaIndex` is that record table, produced by ONE header-only scan
(no payload bytes are touched; varray extents come from the count-entry
tables).  With it, :meth:`repro.core.reader.ScdaReader.seek_section` jumps
any rank straight to any section and the existing windowed/element reads
work unchanged — the format becomes an archive instead of a tape.

The index is cacheable as a ``.scdax`` sidecar which is itself a valid
scda file (an I section with a cheap staleness probe plus a §3.2-encoded
B section holding the entry table as JSON), so ``scdatool`` and foreign
readers can inspect it with the ordinary format tools.  A sidecar is never
trusted blindly: loading verifies the target's file size, and every seek
re-reads the section's on-disk 64-byte header and compares it against the
entry (see :meth:`ScdaReader.seek_section`), so a stale index can fail
loudly but can never return wrong bytes silently.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Dict, List, Optional, Tuple

from repro_torch.core import codec, spec
from repro_torch.core.comm import Communicator
from repro_torch.core.errors import ScdaError, ScdaErrorCode

#: Sidecar naming convention: ``<file>.scdax`` next to ``<file>``.
SIDECAR_SUFFIX = ".scdax"
#: File-header user string identifying a sidecar.
SIDECAR_USER_STRING = b"scdax 00"
#: Section user strings inside the sidecar.
SIDECAR_TARGET_USER = b"scdax target"
SIDECAR_ENTRIES_USER = b"scdax entries"
#: Sidecar JSON schema version.
INDEX_FORMAT = "repro-scdax"
INDEX_VERSION = 1

#: kind → (on-disk letter of the section's FIRST physical header, fixed
#: user string for encoded kinds or None = the entry's own user string).
_RAW_HEADER: Dict[str, Tuple[bytes, Optional[bytes]]] = {
    "I": (b"I", None), "B": (b"B", None),
    "A": (b"A", None), "V": (b"V", None),
    "zB": (b"I", codec.MAGIC_BLOCK),
    "zA": (b"I", codec.MAGIC_ARRAY),
    "zV": (b"A", codec.MAGIC_VARRAY),
}

_ENTRY_FIELDS = ("kind", "N", "E", "decoded", "start", "end", "data_start",
                 "entries_start", "v_entries_start", "v_data_start",
                 "raw_E", "payload_bytes")


@dataclasses.dataclass(frozen=True)
class IndexEntry:
    """One logical section's type, geometry, and absolute file offsets.

    A §3-encoded section (kind ``zB``/``zA``/``zV``) spans two physical
    sections on disk but is ONE logical entry here, mirroring what
    ``read_section_header(decode=True)`` reports.  ``payload_bytes`` is the
    on-disk data byte count (compressed size for encoded kinds); logical
    sizes live in ``N``/``E`` exactly as in :class:`SectionHeader`.
    """
    kind: str            # 'I'|'B'|'A'|'V'|'zB'|'zA'|'zV' (physical layout)
    type: str            # logical type letter, as SectionHeader.type
    user_string: bytes
    N: int
    E: int
    decoded: bool
    start: int           # absolute offset of the (first) section header
    end: int             # absolute offset just past the final pad byte
    data_start: int = 0
    entries_start: int = 0
    v_entries_start: int = 0
    v_data_start: int = 0
    raw_E: int = 0
    payload_bytes: int = 0
    #: CRC32 of the section's *decoded logical payload* (inline data,
    #: block/array data bytes, varray elements concatenated — after §3
    #: decoding for encoded kinds), recorded by ``scdatool index
    #: --checksums``.  None when never computed; excluded from equality
    #: so a checksummed sidecar still deep-verifies against a fresh
    #: (checksum-free) scan.  Re-encoding preserves it, exactly as
    #: ``scdatool diff`` compares logically.
    crc32: Optional[int] = dataclasses.field(default=None, compare=False)

    def header(self):
        from repro_torch.core.reader import SectionHeader
        return SectionHeader(self.type, self.user_string, N=self.N,
                             E=self.E, decoded=self.decoded)

    def raw_header(self) -> Tuple[bytes, bytes]:
        """(letter, user string) of the on-disk header at ``start``."""
        letter, fixed_user = _RAW_HEADER[self.kind]
        return letter, self.user_string if fixed_user is None else fixed_user

    def to_pending(self):
        """The reader cursor state a forward walk would have produced."""
        from repro_torch.core.reader import _Pending
        return _Pending(self.kind, self.header(),
                        data_start=self.data_start,
                        entries_start=self.entries_start,
                        v_entries_start=self.v_entries_start,
                        v_data_start=self.v_data_start,
                        raw_E=self.raw_E)


@dataclasses.dataclass
class ScdaIndex:
    """The complete section table of one scda file."""
    path: str
    file_size: int
    scda_version: int
    vendor: bytes
    user_string: bytes
    entries: List[IndexEntry]

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self):
        return iter(self.entries)

    # -- construction ---------------------------------------------------------
    @classmethod
    def build(cls, source,
              comm: Optional[Communicator] = None) -> "ScdaIndex":
        """One header-only scan of ``source`` (a path or an open reader).

        Rank-local (every rank parses the identical bytes, §A.5.1's
        standard pattern), so no communicator is required; one may be
        passed for a collective open.
        """
        from repro_torch.core.reader import ScdaReader, fopen_read
        if isinstance(source, ScdaReader):
            return cls._build_from(source)
        with fopen_read(comm, source) as r:
            return cls._build_from(r)

    @classmethod
    def _build_from(cls, r) -> "ScdaIndex":
        r._backend.advise(0, r._file_size, "sequential")
        r._pending = None
        r.cursor = spec.FILE_HEADER_BYTES
        return cls(path=r.path, file_size=r._file_size,
                   scda_version=r.version, vendor=r.vendor,
                   user_string=r.user_string, entries=cls._scan_entries(r))

    @classmethod
    def build_prefix(cls, source,
                     comm: Optional[Communicator] = None) -> "ScdaIndex":
        """Index the longest valid *section prefix* of a damaged archive.

        Like :meth:`build`, but a group-1 (corrupt-contents) error stops
        the scan at the last clean section boundary instead of raising —
        the salvage primitive behind tolerant restores and ``scdatool
        repair``.  The result's ``file_size`` is the prefix end, i.e. the
        exact truncation point that would make the file fsck-clean; a
        corrupt *file header* (no valid prefix at all) still raises, as
        do group-2 file-system errors.
        """
        from repro_torch.core.reader import ScdaReader, fopen_read
        if isinstance(source, ScdaReader):
            return cls._build_prefix_from(source)
        with fopen_read(comm, source) as r:
            return cls._build_prefix_from(r)

    @classmethod
    def _build_prefix_from(cls, r) -> "ScdaIndex":
        r._backend.advise(0, r._file_size, "sequential")
        r._pending = None
        r.cursor = spec.FILE_HEADER_BYTES
        entries: List[IndexEntry] = []
        try:
            cls._scan_entries(r, out=entries)
        except ScdaError as e:
            if e.group != 1:
                raise
        end = entries[-1].end if entries else spec.FILE_HEADER_BYTES
        return cls(path=r.path, file_size=end,
                   scda_version=r.version, vendor=r.vendor,
                   user_string=r.user_string, entries=entries)

    @staticmethod
    def _scan_entries(r, out: Optional[List[IndexEntry]] = None
                      ) -> List[IndexEntry]:
        """Header-only walk from the reader's current cursor to EOF.

        With ``out`` the entries accumulate into the caller's list, so a
        scan that raises mid-file still leaves every section completed
        *before* the failure visible (the prefix-salvage path).
        """
        entries: List[IndexEntry] = [] if out is None else out
        while not r.at_eof:
            start = r.cursor
            hdr = r.read_section_header(decode=True)
            p = r._pending
            r.skip_data()  # records p.total_bytes, advances the cursor
            entries.append(IndexEntry(
                kind=p.kind, type=hdr.type, user_string=hdr.user_string,
                N=hdr.N, E=hdr.E, decoded=hdr.decoded,
                start=start, end=r.cursor,
                data_start=p.data_start, entries_start=p.entries_start,
                v_entries_start=p.v_entries_start,
                v_data_start=p.v_data_start, raw_E=p.raw_E,
                payload_bytes=p.total_bytes or 0))
        return entries

    # -- incremental refresh (the mode-'a' append path) -----------------------
    def staleness(self) -> str:
        """Cheap size-probe classification of this index vs. the file now.

        ``"fresh"`` — sizes match (per-seek header checks still guard
        same-size rewrites, as always); ``"grew"`` — the file gained
        bytes, so :meth:`extend` can scan just the appended suffix;
        ``"rewritten"`` — the file shrank or vanished, only a full
        rebuild can describe it.
        """
        try:
            size = os.stat(self.path).st_size
        except OSError:
            return "rewritten"
        if size == self.file_size:
            return "fresh"
        return "grew" if size > self.file_size else "rewritten"

    def extend(self, source=None) -> "ScdaIndex":
        """Refresh this index against the file as it stands now.

        The incremental mirror of :meth:`build` for appendable archives:
        a file that merely *grew* (mode-'a' appends, journal flushes) is
        scanned only over the appended suffix — the existing entries
        describe bytes that did not move — after re-verifying the last
        indexed section's on-disk header, so a rewrite that happens to be
        larger can never smuggle stale offsets through.  A shrunk,
        rewritten, or header-changed file falls back to a full rebuild.
        Returns ``self`` unchanged when the file did not change size, a
        new :class:`ScdaIndex` otherwise; existing entries (checksums
        included) are preserved across a suffix scan.  Raises the
        reader's CORRUPT_* errors if the appended suffix is invalid.
        """
        from repro_torch.core.reader import ScdaReader, fopen_read
        if source is None or not isinstance(source, ScdaReader):
            with fopen_read(None, source or self.path) as r:
                return self._extend_from(r)
        return self._extend_from(source)

    def _extend_from(self, r) -> "ScdaIndex":
        if (r._file_size < self.file_size
                or r.version != self.scda_version
                or r.vendor != self.vendor
                or r.user_string != self.user_string):
            return ScdaIndex._build_from(r)
        if self.entries:
            last = self.entries[-1]
            try:
                r.verify_index_entry(len(self.entries) - 1, last)
            except ScdaError:
                return ScdaIndex._build_from(r)
        if r._file_size == self.file_size:
            return self
        r._pending = None
        r.cursor = self.entries[-1].end if self.entries \
            else spec.FILE_HEADER_BYTES
        suffix = self._scan_entries(r)
        out = dataclasses.replace(self, file_size=r._file_size,
                                  entries=self.entries + suffix)
        return out

    # -- lookup ---------------------------------------------------------------
    def find(self, user_string: bytes, occurrence: int = 0) -> int:
        """Index of the ``occurrence``-th section with ``user_string``, or -1.

        O(1) after the first call: a user-string table is built lazily so
        per-leaf lookups during a lazy restore stay O(leaves), not
        O(leaves × sections).
        """
        by = getattr(self, "_by_user", None)
        if by is None:
            by = {}
            for i, e in enumerate(self.entries):
                by.setdefault(e.user_string, []).append(i)
            self._by_user = by
        hits = by.get(user_string, ())
        return hits[occurrence] if 0 <= occurrence < len(hits) else -1

    # -- verification ---------------------------------------------------------
    def verify(self, deep: bool = False) -> None:
        """Check this index still describes the file at ``path``.

        Shallow (default): the target's size must match — any append,
        truncation, or rewrite-through-rename changes it in practice, and
        per-seek header re-reads catch same-size rewrites.  ``deep``
        rebuilds the index from the file and requires identical entries.
        Raises :class:`ScdaError` (CORRUPT group) on any mismatch.
        """
        try:
            size = os.stat(self.path).st_size
        except OSError as e:
            raise ScdaError(ScdaErrorCode.FS_READ,
                            f"{self.path}: {e}") from e
        if size != self.file_size:
            how = "grew (extend can re-scan the suffix)" if \
                size > self.file_size else "was rewritten or truncated"
            raise ScdaError(ScdaErrorCode.CORRUPT_TRUNCATED,
                            f"stale index: file is {size} bytes, index "
                            f"recorded {self.file_size} — the file {how}")
        if deep:
            fresh = ScdaIndex.build(self.path)
            if fresh.entries != self.entries:
                raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                                "stale index: section table does not match "
                                "a fresh scan")

    # -- payload checksums (the verify-without-a-reference manifest) ----------
    @staticmethod
    def _section_crc(r, i: int) -> int:
        """CRC32 of section ``i``'s decoded logical payload.

        Raw A sections stream through windowed reads, so a terabyte raw
        leaf checksums in bounded memory; encoded kinds (zA/V/zV) run
        the full decode chain — a checksum match therefore also proves
        the §3 framing, base64 geometry, and zlib adler32 of every
        payload byte it covers — at the cost of materializing each
        section's decoded elements while it is checksummed.
        """
        hdr = r.seek_section(i)
        crc = 0
        if hdr.type == "I":
            crc = zlib.crc32(r.read_inline_data())
        elif hdr.type == "B":
            crc = zlib.crc32(r.read_block_data())
        elif hdr.type == "A" and not hdr.decoded:
            # Raw A sections can be huge (checkpoint leaves are E=1 with
            # N in the millions); windowed reads keep memory bounded
            # instead of materializing one buffer per element.
            step = max(1, (1 << 20) // max(1, hdr.E))
            for start in range(0, hdr.N, step):
                n = min(step, hdr.N - start)
                crc = zlib.crc32(r.read_array_windows([(start, n)],
                                                      hdr.E)[0], crc)
            r.skip_data()
        elif hdr.type == "A":
            for chunk in r.read_array_data([hdr.N]):
                crc = zlib.crc32(chunk, crc)
        else:  # V
            sizes = r.read_varray_sizes([hdr.N])
            for chunk in r.read_varray_data([hdr.N], sizes):
                crc = zlib.crc32(chunk, crc)
        return crc

    def with_checksums(self, reader=None,
                       only_missing: bool = False) -> "ScdaIndex":
        """A copy of this index with every entry's ``crc32`` computed.

        ``scdatool index --checksums`` writes the result as the sidecar:
        a checksum manifest that lets ``scdatool verify`` validate the
        archive later without a reference copy (ROADMAP open item).

        ``only_missing`` re-checksums nothing that already has a CRC —
        after :meth:`extend` only the appended sections lack one, so an
        incremental sidecar refresh costs one decode pass over the
        *suffix*, not the archive.
        """
        from repro_torch.core.reader import fopen_read
        if reader is None:
            with fopen_read(None, self.path) as r:
                return self.with_checksums(r, only_missing=only_missing)
        reader.set_index(self)
        entries = [e if only_missing and e.crc32 is not None
                   else dataclasses.replace(
                       e, crc32=self._section_crc(reader, i))
                   for i, e in enumerate(self.entries)]
        return dataclasses.replace(self, entries=entries)

    def has_checksums(self) -> bool:
        """True when every entry carries a recorded payload ``crc32`` —
        the precondition for ``scdatool verify`` to fully cover a file."""
        return all(e.crc32 is not None for e in self.entries)

    def verify_checksums(self, reader=None) -> List[str]:
        """Re-read every payload and compare against the recorded CRCs.

        Returns a list of human-readable problems (empty = verified).
        Entries without a recorded ``crc32`` are reported — an archive
        "verifies" only if every section is actually covered.  Decode
        failures (corrupt §3 framing, truncation) are reported per
        section rather than raised, so one rotten leaf doesn't hide the
        state of the rest.
        """
        from repro_torch.core.reader import fopen_read
        if reader is None:
            with fopen_read(None, self.path) as r:
                return self.verify_checksums(r)
        problems: List[str] = []
        reader.set_index(self)
        for i, e in enumerate(self.entries):
            name = e.user_string.decode("latin-1")
            if e.crc32 is None:
                problems.append(f"section {i} ({name!r}): no checksum "
                                f"recorded (re-run scdatool index "
                                f"--checksums)")
                continue
            try:
                got = self._section_crc(reader, i)
            except ScdaError as err:
                problems.append(f"section {i} ({name!r}): unreadable: "
                                f"{err}")
                continue
            if got != e.crc32:
                problems.append(f"section {i} ({name!r}): payload CRC32 "
                                f"{got:#010x} != recorded {e.crc32:#010x}")
        return problems

    def check_checksums(self, reader=None) -> None:
        """Like :meth:`verify_checksums`, but raising — the
        verify-on-restore path (``restore(..., verify=True)``).

        The first mismatch raises CORRUPT_CHECKSUM carrying the exact
        starting byte offset of the failing section's payload
        (``ScdaError.offset``); a section without a recorded CRC raises
        ARG_SEQUENCE pointing at ``scdatool index --checksums``, since a
        "verified" restore that silently skipped sections would be a
        lie.
        """
        from repro_torch.core.reader import fopen_read
        if reader is None:
            with fopen_read(None, self.path) as r:
                self.check_checksums(r)
                return
        reader.set_index(self)
        for i, e in enumerate(self.entries):
            name = e.user_string.decode("latin-1")
            if e.crc32 is None:
                raise ScdaError(
                    ScdaErrorCode.ARG_SEQUENCE,
                    f"{self.path}: section {i} ({name!r}) has no "
                    f"recorded checksum — run scdatool index "
                    f"--checksums first")
            got = self._section_crc(reader, i)
            if got != e.crc32:
                raise ScdaError(
                    ScdaErrorCode.CORRUPT_CHECKSUM,
                    f"{self.path}: section {i} ({name!r}): payload "
                    f"CRC32 {got:#010x} != recorded {e.crc32:#010x}",
                    offset=e.data_start)

    # -- sidecar (.scdax — itself a valid scda file) --------------------------
    def sidecar_path(self, sidecar: Optional[str] = None) -> str:
        return sidecar or self.path + SIDECAR_SUFFIX

    def _target_probe(self) -> bytes:
        text = f"size {self.file_size:>25}\n"
        return text.encode("ascii").ljust(spec.INLINE_DATA_BYTES)[
            :spec.INLINE_DATA_BYTES]

    def to_json(self) -> bytes:
        doc = {
            "format": INDEX_FORMAT,
            "version": INDEX_VERSION,
            "target": {
                "size": self.file_size,
                "scda_version": self.scda_version,
                "vendor": self.vendor.decode("latin-1"),
                "user_string": self.user_string.decode("latin-1"),
            },
            "sections": [
                {"type": e.type,
                 "user_string": e.user_string.decode("latin-1"),
                 **{f: getattr(e, f) for f in _ENTRY_FIELDS},
                 # backward-compatible extra key: absent when not computed,
                 # ignored by readers that predate it
                 **({"crc32": e.crc32} if e.crc32 is not None else {})}
                for e in self.entries
            ],
        }
        return json.dumps(doc, indent=1, sort_keys=True).encode("ascii")

    @classmethod
    def from_json(cls, raw: bytes, path: str) -> "ScdaIndex":
        try:
            doc = json.loads(raw.decode("ascii"))
        except (ValueError, UnicodeDecodeError) as e:
            raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                            f"sidecar JSON: {e}") from e
        if doc.get("format") != INDEX_FORMAT:
            raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                            f"not a scdax document: {doc.get('format')!r}")
        if doc.get("version") != INDEX_VERSION:
            raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                            f"unsupported scdax version {doc.get('version')}")
        try:
            t = doc["target"]
            entries = [
                IndexEntry(type=s["type"],
                           user_string=s["user_string"].encode("latin-1"),
                           crc32=s.get("crc32"),
                           **{f: s[f] for f in _ENTRY_FIELDS})
                for s in doc["sections"]
            ]
            return cls(path=path, file_size=int(t["size"]),
                       scda_version=int(t["scda_version"]),
                       vendor=t["vendor"].encode("latin-1"),
                       user_string=t["user_string"].encode("latin-1"),
                       entries=entries)
        except (KeyError, TypeError, ValueError) as e:
            raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                            f"malformed scdax document: {e}") from e

    def write_sidecar(self, sidecar: Optional[str] = None) -> str:
        """Atomically write the ``.scdax`` sidecar; returns its path."""
        from repro_torch.core.writer import fopen_write
        sp = self.sidecar_path(sidecar)
        tmp = sp + ".tmp"
        with fopen_write(None, tmp, user_string=SIDECAR_USER_STRING,
                         sync=True) as f:
            f.write_inline(SIDECAR_TARGET_USER, self._target_probe())
            f.write_block(SIDECAR_ENTRIES_USER, self.to_json(), encode=True)
        # Durable rename: a stale sidecar is only *detected* (staleness
        # probe) — a resurrected half-renamed one must never be possible.
        from repro_torch.core.io_backend import replace_durable
        replace_durable(tmp, sp)
        return sp

    @classmethod
    def write_sidecars(cls, paths: List[str],
                       comm: Optional[Communicator] = None,
                       strict: bool = False) -> List[str]:
        """Build and atomically write sidecars for several related
        archives — a sharded checkpoint commits its N shard files and
        manifest together, and wants all their indexes refreshed as one
        post-commit step.  Best-effort by default (an unwritable
        directory or a torn file skips that sidecar and moves on, like
        the manager's post-commit behavior); ``strict`` re-raises
        instead.  Returns the sidecar paths actually written."""
        written: List[str] = []
        for p in paths:
            try:
                written.append(cls.build(p, comm).write_sidecar())
            except (ScdaError, OSError):
                if strict:
                    raise
        return written

    @classmethod
    def load_sidecar(cls, path: str, sidecar: Optional[str] = None,
                     verify: bool = True) -> "ScdaIndex":
        """Load ``<path>.scdax`` and (by default) verify it against the file."""
        from repro_torch.core.reader import fopen_read
        sp = sidecar or path + SIDECAR_SUFFIX
        with fopen_read(None, sp) as r:
            if r.user_string != SIDECAR_USER_STRING:
                raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                                f"{sp}: not a scdax sidecar "
                                f"({r.user_string!r})")
            hdr = r.read_section_header()
            if hdr.type != "I" or hdr.user_string != SIDECAR_TARGET_USER:
                raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                                f"{sp}: missing target probe section")
            r.read_inline_data()
            hdr = r.read_section_header()
            if hdr.type != "B" or hdr.user_string != SIDECAR_ENTRIES_USER:
                raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                                f"{sp}: missing entries section")
            idx = cls.from_json(r.read_block_data(), path)
        if verify:
            idx.verify()
        return idx

    @classmethod
    def refresh_sidecar(cls, path: str, sidecar: Optional[str] = None,
                        checksums: Optional[bool] = None) \
            -> Optional["ScdaIndex"]:
        """Incrementally refresh ``path``'s sidecar after an append.

        Returns the refreshed index, or None when no sidecar exists (an
        archive that never had one keeps not having one — readers scan).
        A sidecar stale because the file *grew* is extended by a suffix
        scan; a rewritten file gets a full rebuild; the replacement write
        is atomic (temp + rename), so concurrent readers only ever see a
        complete sidecar.  ``checksums=None`` preserves the manifest
        property: if the old sidecar recorded payload CRCs, the appended
        sections are checksummed too (suffix-only decode pass), so
        ``scdatool verify`` keeps covering the whole file.
        """
        sp = sidecar or path + SIDECAR_SUFFIX
        if not os.path.exists(sp):
            return None
        old = cls.load_sidecar(path, sidecar, verify=False)
        idx = old.extend()
        want_crcs = checksums if checksums is not None \
            else (bool(old.entries) and old.has_checksums())
        if want_crcs and not idx.has_checksums():
            idx = idx.with_checksums(only_missing=True)
        idx.write_sidecar(sidecar)
        return idx

    @classmethod
    def cached(cls, path: str, comm: Optional[Communicator] = None,
               write: bool = True,
               sidecar: Optional[str] = None) -> "ScdaIndex":
        """The standard entry point: sidecar if fresh, else scan (and cache).

        A sidecar stale only because the file grew (mode-'a' appends) is
        extended with a suffix-only scan; a missing, rewritten, or
        corrupt sidecar falls back to a fresh header-only scan.  With
        ``write``, rank 0 then refreshes the sidecar best-effort (an
        unwritable directory never fails the read path).
        """
        try:
            return cls.load_sidecar(path, sidecar)
        except (ScdaError, OSError):
            pass
        idx = None
        try:
            # Suffix-scan fast path for grown files; extend() degrades to
            # a full rebuild for rewritten ones all by itself.
            idx = cls.load_sidecar(path, sidecar, verify=False).extend()
        except (ScdaError, OSError):
            idx = None
        if idx is None:
            idx = cls.build(path)
        if write and (comm is None or comm.rank == 0):
            try:
                idx.write_sidecar(sidecar)
            except (ScdaError, OSError):
                pass
        return idx
