"""Streaming journal on appendable scda archives.

Long-running training jobs emit two data streams: big, periodic state
snapshots (checkpoints) and a small, continuous trickle of telemetry —
loss curves, learning rates, eval scalars, wall-clock marks.  Historically
the trickle lands in ad-hoc side files; this module streams it *into the
same scda archive the checkpoint lives in* (cf. Lemon's LIME records and
H5MD's in-place time-series groups), so one file carries the state AND the
story of how it got there, inspectable with the ordinary format tools.

Mechanics: :meth:`ScdaJournal.log` buffers records in memory;
:meth:`ScdaJournal.flush` opens the target archive in mode 'a'
(:func:`repro.core.writer.fopen_append` — tail-validated, byte-identical
to a longer serial session) and writes the buffered batch as ONE framed
varray section (user string ``"scda-journal 00"``, one JSON record per
element), then refreshes the ``.scdax`` sidecar incrementally and
atomically so ``seek_section``/lazy restores never see a torn index.
Auto-flush every ``REPRO_SCDA_JOURNAL_FLUSH`` records (default 64; 0 =
explicit flush only).  A previous flush torn by a crash is healed on the
next one (``recover=True`` truncates back to the last valid section
boundary — whole-section framing means a record is either fully on disk
or not at all).

Records are JSON objects ``{"v": 1, "step": <int|None>, "data": {name:
scalar}}``; pytrees of scalars flatten to '/'-joined names exactly like
checkpoint leaves.  ``scdatool tail`` prints them; ``iter_records`` /
``read_records`` are the library mirror.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.errors import ScdaError, ScdaErrorCode
from repro_torch.core.index import ScdaIndex
from repro_torch.core.reader import fopen_read
from repro_torch.core.writer import fopen_append

#: Section user string identifying journal sections inside any archive.
JOURNAL_USER_STRING = b"scda-journal 00"
#: Record schema version (the "v" key of every record).
RECORD_VERSION = 1
#: Default auto-flush threshold (records); env-overridable.
DEFAULT_FLUSH_RECORDS = 64


def journal_flush_records() -> int:
    """The effective auto-flush threshold, read from the environment per
    call (``REPRO_SCDA_JOURNAL_FLUSH``; 0 disables auto-flush)."""
    raw = os.environ.get("REPRO_SCDA_JOURNAL_FLUSH", "")
    try:
        return max(0, int(raw)) if raw else DEFAULT_FLUSH_RECORDS
    except ValueError:
        return DEFAULT_FLUSH_RECORDS


def _scalar(name: str, value: Any):
    """Coerce one leaf to a JSON scalar; reject anything with extent."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    try:
        arr = np.asarray(value)  # numpy/jax scalars and 0-d arrays
    except Exception:
        arr = None
    if arr is not None and arr.ndim == 0:
        return arr.item()
    raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                    f"journal record leaf {name!r} is not a scalar "
                    f"({type(value).__name__})")


def flatten_scalars(tree: Any) -> Dict[str, Any]:
    """Flatten a pytree of scalars to '/'-joined names (dicts and
    lists/tuples recurse; everything else must be a JSON-able scalar,
    numpy/jax 0-d arrays included).  No jax import — the journal stays
    usable from pure-numpy telemetry code."""
    out: Dict[str, Any] = {}

    def walk(prefix: str, obj: Any) -> None:
        if isinstance(obj, dict):
            for k in sorted(obj, key=str):
                walk(f"{prefix}/{k}" if prefix else str(k), obj[k])
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(f"{prefix}/{i}" if prefix else str(i), v)
        else:
            out[prefix or "."] = _scalar(prefix or ".", obj)

    walk("", tree)
    return out


def encode_record(step: Optional[int], scalars: Any) -> bytes:
    """One journal record (a varray element) as canonical JSON bytes."""
    doc = {"v": RECORD_VERSION,
           "step": None if step is None else int(step),
           "data": flatten_scalars(scalars)}
    return json.dumps(doc, sort_keys=True,
                      separators=(",", ":")).encode("ascii")


def decode_record(raw: bytes) -> Dict[str, Any]:
    try:
        doc = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                        f"journal record: {e}") from e
    if not isinstance(doc, dict) or "data" not in doc:
        raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                        "journal record is not a {step, data} object")
    return doc


class ScdaJournal:
    """Buffered telemetry writer appending to one scda archive.

    ``path`` may be None at construction (a training run that has not
    committed its first checkpoint yet): records buffer until
    :meth:`retarget` points the journal at a file.  The journal is a
    rank-0 facility — metrics are replicated, so exactly one process
    should flush (the checkpoint manager wires this up).

    ``flush_records=None`` takes ``REPRO_SCDA_JOURNAL_FLUSH`` (default
    64; 0 = explicit :meth:`flush` only).  ``update_sidecar`` refreshes
    the ``.scdax`` atomically after each flush (suffix-only scan, CRCs
    preserved); ``sync`` makes each flush a durable collective close.
    ``enabled=False`` turns the journal into an inert sink (log and
    flush are no-ops) — what the manager hands every rank but 0, so
    replicated training code can log unconditionally without non-root
    ranks buffering unboundedly or double-appending.
    """

    def __init__(self, path: Optional[str] = None, *,
                 flush_records: Optional[int] = None,
                 sync: bool = False,
                 update_sidecar: bool = True,
                 enabled: bool = True) -> None:
        self.path = path
        self.flush_records = journal_flush_records() \
            if flush_records is None else max(0, int(flush_records))
        self.sync = sync
        self.update_sidecar = update_sidecar
        self.enabled = enabled
        self._buf: List[bytes] = []
        # One lock serializes log/flush/retarget: the checkpoint manager
        # flushes from its ASYNC save thread (flush-on-commit) while the
        # training thread keeps logging — without it two flushes could
        # append at the same resume cursor (torn tail) and records logged
        # mid-flush could be dropped with the swapped-out buffer.
        self._lock = threading.RLock()

    # -- writing ---------------------------------------------------------------
    @property
    def pending(self) -> int:
        """Records buffered in memory, not yet on disk."""
        with self._lock:
            return len(self._buf)

    def log(self, step: Optional[int], scalars: Any) -> None:
        """Buffer one record; auto-flush at the configured threshold.

        Encoding happens NOW (cheap, and errors surface at the log site);
        the disk write is deferred to a flush, so the training loop never
        waits on an append unless it crosses the threshold.  Thread-safe
        against a concurrent :meth:`flush` (the manager's async commit).
        """
        if not self.enabled:
            return
        record = encode_record(step, scalars)
        with self._lock:
            self._buf.append(record)
            if (self.flush_records and self.path is not None
                    and len(self._buf) >= self.flush_records):
                try:
                    self.flush()
                except (ScdaError, OSError):
                    # Telemetry must never crash the training loop on a
                    # transient disk error: the records stay buffered
                    # (flush clears only on success) and the error
                    # resurfaces on an *explicit* flush()/close().
                    pass

    def retarget(self, path: str) -> None:
        """Point future flushes at ``path`` (buffered records carry over)
        — the checkpoint manager calls this at every commit so telemetry
        follows the newest checkpoint file."""
        with self._lock:
            self.path = path

    def flush(self) -> int:
        """Append all buffered records as one framed varray section.

        Returns the number of records written (0 when the buffer is
        empty or no target is set).  The buffer is cleared only on
        success — a failed flush keeps the records for the next attempt,
        and ``recover=True`` on the append heals a previously torn tail
        (whole-section framing: partially appended records never count).
        Serialized against concurrent log/flush callers.
        """
        with self._lock:
            if not self.enabled or not self._buf or self.path is None:
                return 0
            records = self._buf
            sizes = [len(b) for b in records]
            with fopen_append(None, self.path, sync=self.sync,
                              recover=True) as f:
                f.write_varray(JOURNAL_USER_STRING, records,
                               [len(records)], sizes)
            self._buf = []
            path = self.path
        if self.update_sidecar:
            try:
                ScdaIndex.refresh_sidecar(path)
            except (ScdaError, OSError):
                pass  # best-effort, like the manager's commit sidecars
        return len(records)

    def close(self) -> int:
        """Flush any buffered tail; the journal object stays reusable."""
        return self.flush()

    def __enter__(self) -> "ScdaJournal":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # Don't mask an in-flight exception with a flush failure, and
        # don't flush mid-crash state either.
        if exc_type is None:
            self.close()


# -- reading (the scdatool-tail mirror) --------------------------------------

def iter_records(path: str, start_section: int = 0,
                 index: Optional[ScdaIndex] = None) \
        -> Iterator[Tuple[int, Dict[str, Any]]]:
    """Yield ``(section_index, record)`` for every journal record at or
    after ``start_section``, in file order.

    Non-journal sections are skipped, so journals interleave freely with
    checkpoint leaves.  §3-encoded journal sections (a ``scdatool copy
    --recompress`` output) decode transparently, exactly like raw ones.
    Pass a pre-built ``index`` to skip the header scan (``scdatool tail
    --follow`` extends one incrementally between polls and resumes from
    the previously seen section count).
    """
    with fopen_read(None, path) as r:
        if index is not None:
            r.set_index(index)
        try:
            idx = r.index()
        except ScdaError as e:
            if e.group != 1:
                raise
            # A power cut can tear the newest append; every record in
            # the valid prefix is still whole-section framed and
            # readable (the next flush truncates and heals the tail).
            idx = ScdaIndex.build_prefix(r)
            r.set_index(idx)
        for i in range(max(0, start_section), len(idx.entries)):
            e = idx.entries[i]
            if e.user_string != JOURNAL_USER_STRING or e.type != "V":
                continue
            hdr = r.seek_section(i)
            sizes = r.read_varray_sizes([hdr.N])
            for raw in r.read_varray_data([hdr.N], sizes):
                yield i, decode_record(raw)


def read_records(path: str) -> List[Dict[str, Any]]:
    """All journal records of ``path``, in append order."""
    return [rec for _, rec in iter_records(path)]
