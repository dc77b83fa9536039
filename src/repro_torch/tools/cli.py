"""``scdatool`` — archive CLI for scda files.

Subcommands::

    scdatool ls FILE                 # section table (via the seekable index)
    scdatool ls --json FILE          # same, machine-readable (checkpoint +
                                     # delta-chain metadata included)
    scdatool cat FILE SECTION        # decoded payload of one section
    scdatool fsck FILE...            # structural validation, non-zero on
                                     # corruption; delta checkpoints also get
                                     # their base links checked
    scdatool index FILE...           # build/refresh (or --check) .scdax sidecars
    scdatool index --checksums F...  # sidecar + per-section payload CRC32s
    scdatool verify FILE...          # re-check payloads against the checksums
    scdatool verify --chain FILE...  # digest-verify a delta checkpoint across
                                     # its whole base chain (CRC32 + SHA-256)
    scdatool copy SRC DST            # rewrite; --recompress / --decompress
    scdatool diff A B                # leaf-wise compare via the indexes
    scdatool diff --logical A B      # chain-aware checkpoint compare (a delta
                                     # chain equals the full state it encodes)
    scdatool squash SRC DST          # materialize a delta chain into one
                                     # self-contained archive
    scdatool append DST SRC...       # grow DST in place (mode 'a') with
                                     # SRC's sections; sidecar refreshed
    scdatool tail FILE               # print journal records; -f follows
                                     # new sections as they land
    scdatool stats FILE...           # per-section stored/logical bytes and
                                     # compression ratios (via the index)
    scdatool stats --trace T.json    # summarize a Chrome trace captured
                                     # with REPRO_SCDA_TRACE: per-stage
                                     # time, syscall counts, bytes, MB/s

``SECTION`` is a section number (as printed by ``ls``) or a user string.
Installed as a console script via ``pyproject.toml``; equivalently
``python -m repro.tools.cli``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from repro_torch.core import (ScdaError, ScdaErrorCode, ScdaIndex, fopen_append,
                        fopen_read, fopen_write)
from repro_torch.core import trace as _trace
from repro_torch.core.index import SIDECAR_SUFFIX
from repro_torch.tools.fsck import (fsck_file, is_sharded_manifest, repair_file,
                              repair_set, sibling_shards_exist)


def _err(msg: str) -> None:
    print(f"scdatool: {msg}", file=sys.stderr)


def _printable(user: bytes) -> str:
    text = user.decode("latin-1")
    return text if text.isprintable() else repr(user)


# -- ls ----------------------------------------------------------------------

def _checkpoint_summary(path: str) -> Optional[dict]:
    """Best-effort checkpoint + delta-chain metadata of a repro
    checkpoint archive; None when ``path`` is not one (or unreadable).
    Reads only the manifest block — never jax, never the leaf payloads.
    Sharded-set manifests summarize via their shard table (existence
    checks only, no shard opens beyond a stat).
    """
    from repro_torch.checkpoint import manifest as mf
    try:
        with fopen_read(None, path) as r:
            idx = r.index()
            sec = idx.find(mf.MANIFEST_USER_STRING)
            if sec < 0:
                if idx.find(mf.SHARDS_MANIFEST_USER_STRING) >= 0:
                    from repro_torch.checkpoint import sharding
                    return sharding.summarize(path)
                return None
            r.seek_section(sec)
            doc = mf.parse(r.read_block_data())
    except (ScdaError, OSError, ValueError):
        return None
    out = {"format": doc.get("format"), "version": doc.get("version"),
           "step": doc.get("step"), "leaves": len(doc.get("leaves", []))}
    delta = doc.get("delta")
    if delta:
        stored = sum(len(l.get("present", []))
                     for l in doc.get("leaves", []))
        total = sum(len((l.get("chunks") or {}).get("hash", ()))
                    for l in doc.get("leaves", []))
        out["delta"] = {"depth": delta.get("depth"),
                        "bases": [dict(b) for b in delta.get("bases", [])],
                        "chunks_stored": stored, "chunks_total": total}
    return out


def _expand_set(path: str) -> List[str]:
    """``[path]`` — or, when ``path`` is a sharded-set manifest, the
    manifest followed by its shard files, so per-file subcommands
    (``verify``, ``index``) accept a manifest path and cover the whole
    set.  Unreadable paths pass through unchanged; the subcommand's own
    error reporting names them."""
    from repro_torch.checkpoint import manifest as mf, sharding
    try:
        with fopen_read(None, path) as r:
            if r.index().find(mf.SHARDS_MANIFEST_USER_STRING) < 0:
                return [path]
        doc = sharding.read_sharded_manifest(path)
    except (ScdaError, OSError, ValueError):
        return [path]
    base = os.path.dirname(path)
    return [path] + [os.path.join(base, s.get("file", ""))
                     for s in doc.get("shards", [])]


def cmd_ls(args) -> int:
    idx = ScdaIndex.build(args.file)
    ckpt = _checkpoint_summary(args.file)
    if args.json:
        doc = {
            "file": args.file,
            "bytes": idx.file_size,
            "scda_version": idx.scda_version,
            "vendor": _printable(idx.vendor),
            "user": _printable(idx.user_string),
            "sections": [
                {"sec": i, "kind": e.kind, "type": e.type, "N": e.N,
                 "E": e.E, "payload": e.payload_bytes, "offset": e.start,
                 "user": _printable(e.user_string)}
                for i, e in enumerate(idx)],
        }
        if ckpt is not None:
            doc["checkpoint"] = ckpt
        print(json.dumps(doc, indent=1, sort_keys=True))
        return 0
    print(f"# {args.file}: {len(idx)} sections, {idx.file_size} bytes, "
          f"scda version {idx.scda_version:#x}, "
          f"vendor {_printable(idx.vendor)!r}, "
          f"user {_printable(idx.user_string)!r}")
    if ckpt is not None and ckpt.get("delta"):
        d = ckpt["delta"]
        bases = ", ".join(b["file"] for b in d["bases"])
        print(f"# delta checkpoint: depth {d['depth']}, "
              f"{d['chunks_stored']}/{d['chunks_total']} chunks stored, "
              f"bases: {bases}")
    if ckpt is not None and ckpt.get("format") == "repro-scda-sharded":
        files = ", ".join(
            s["file"] + ("" if s.get("present") else " (MISSING)")
            for s in ckpt.get("shards", []))
        print(f"# sharded checkpoint: step {ckpt.get('step')}, "
              f"{ckpt.get('leaves')} leaves across "
              f"{len(ckpt.get('shards', []))} shards: {files}")
    print(f"{'sec':>4} {'kind':>4} {'N':>10} {'E':>10} {'payload':>12} "
          f"{'offset':>12}  user string")
    for i, e in enumerate(idx):
        print(f"{i:>4} {e.kind:>4} {e.N:>10} {e.E:>10} "
              f"{e.payload_bytes:>12} {e.start:>12}  "
              f"{_printable(e.user_string)}")
    return 0


# -- cat ---------------------------------------------------------------------

def _resolve_section(idx: ScdaIndex, token: str) -> int:
    if token.isdigit():
        i = int(token)
        if not 0 <= i < len(idx):
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                            f"section {i} outside [0, {len(idx)})")
        return i
    i = idx.find(token.encode("latin-1"))
    if i < 0:
        raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                        f"no section with user string {token!r}")
    return i


def cmd_cat(args) -> int:
    out = sys.stdout.buffer
    with fopen_read(None, args.file) as r:
        idx = r.index()
        i = _resolve_section(idx, args.section)
        e = idx.entries[i]
        if args.element is not None and e.type != "V":
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                            f"--element requires a varray section; "
                            f"section {i} has type {e.type}")
        if args.extent:
            out.write(r._backend.pread(e.start, e.end - e.start))
            return 0
        hdr = r.seek_section(i)
        if hdr.type == "I":
            out.write(r.read_inline_data())
        elif hdr.type == "B":
            out.write(r.read_block_data())
        elif hdr.type == "A":
            for chunk in r.read_array_data([hdr.N]):
                out.write(chunk)
        else:  # V
            if args.element is not None:
                out.write(r.read_varray_elements([args.element])[0])
            else:
                sizes = r.read_varray_sizes([hdr.N])
                for chunk in r.read_varray_data([hdr.N], sizes):
                    out.write(chunk)
    return 0


# -- fsck --------------------------------------------------------------------

def _timed(args, body, label: str) -> int:
    """``--timing``: run ``body`` under a private trace collector and
    print the per-phase wall-time / bytes-scanned breakdown (Metrics
    counters from the syscall choke point) after its normal output."""
    tc = _trace.TraceCollector()
    t0 = tc.now()
    with _trace.scoped(tc):
        status = body(args)
    wall_ms = (tc.now() - t0) / 1e6
    snap = tc.metrics.snapshot()
    ctr = snap["counters"]
    scanned = ctr.get("io.pread.bytes", 0) + ctr.get("io.preadv.bytes", 0)
    calls = sum(v for k, v in ctr.items()
                if k.startswith("io.") and k.endswith(".calls"))
    print(f"# {label} timing: {wall_ms:.1f} ms wall, {scanned} bytes "
          f"scanned, {calls} syscalls")
    phases = sorted(((h["total_us"], name[:-3], h["count"])
                     for name, h in snap["histograms"].items()
                     if name.endswith(".us")), reverse=True)
    for total_us, name, count in phases:
        print(f"#   {name:<24} {count:>7} calls {total_us / 1e3:>9.1f} ms")
    return status


def cmd_fsck(args) -> int:
    if args.timing:
        return _timed(args, _fsck_body, "fsck")
    return _fsck_body(args)


def _fsck_body(args) -> int:
    status = 0
    for path in args.files:
        findings = fsck_file(path, deep=not args.fast,
                             check_sidecar=not args.no_sidecar)
        errors = sum(f.severity == "error" for f in findings)
        warnings = len(findings) - errors
        for f in findings:
            if not args.quiet or f.severity == "error":
                print(f"{path}: {f}")
        if errors or (args.strict and warnings):
            status = 1
            print(f"{path}: CORRUPT ({errors} errors, {warnings} warnings)")
        else:
            print(f"{path}: clean ({warnings} warnings)")
    return status


# -- repair ------------------------------------------------------------------

def cmd_repair(args) -> int:
    """Salvage the valid prefix of damaged archives (fsck's fixer twin).

    Exit 0 when every file ends up clean or repaired; 1 when anything is
    unrecoverable — or, under ``--dry-run``, when a repair *would* be
    needed (so scripts can probe without mutating).
    """
    status = 0
    for path in args.files:
        # A mangled manifest may not self-identify as a set — shard
        # files named for its stem are evidence enough to route it
        # through set repair (which can rebuild the manifest itself).
        if is_sharded_manifest(path) or sibling_shards_exist(path):
            results = repair_set(path, quarantine=not args.no_quarantine,
                                 dry_run=args.dry_run,
                                 sidecar=not args.no_sidecar,
                                 rebuild=args.rebuild)
        else:
            results = [repair_file(path, quarantine=not args.no_quarantine,
                                   dry_run=args.dry_run,
                                   sidecar=not args.no_sidecar)]
        for r in results:
            print(r)
            if r.action in ("unrecoverable", "would-repair",
                            "would-rebuild"):
                status = 1
    return status


# -- index -------------------------------------------------------------------

def cmd_index(args) -> int:
    status = 0
    for path in [p for f in args.files for p in _expand_set(f)]:
        sidecar = path + SIDECAR_SUFFIX
        if args.check:
            try:
                idx = ScdaIndex.load_sidecar(path)
                idx.verify(deep=True)
                if args.checksums and not idx.has_checksums():
                    _err(f"{sidecar}: fresh but records no payload "
                         f"checksums (write them with: scdatool index "
                         f"--checksums)")
                    status = 1
                else:
                    print(f"{sidecar}: fresh")
            except (ScdaError, OSError) as e:
                _err(f"{sidecar}: {e}")
                status = 1
            continue
        with fopen_read(None, path) as r:
            idx = r.index()
            if args.checksums:
                idx = idx.with_checksums(r)
        idx.write_sidecar()
        print(f"{sidecar}: {len(idx)} sections indexed"
              + (" (with payload checksums)" if args.checksums else ""))
    return status


# -- verify ------------------------------------------------------------------

def cmd_verify(args) -> int:
    """Validate archives against their sidecar checksum manifests.

    The reference-free integrity check (``diff`` needs a second copy;
    ``verify`` does not): loads the ``.scdax`` sidecar written by
    ``index --checksums``, confirms it still describes the file, then
    re-reads and re-decodes every payload and compares CRC32s.  Exit 1
    on any mismatch, unreadable section, missing checksum, or missing
    sidecar.
    """
    if args.timing:
        return _timed(args, _verify_body, "verify")
    return _verify_body(args)


def _verify_body(args) -> int:
    status = 0
    if args.chain:
        from repro_torch.checkpoint.delta import verify_chain
        for path in args.files:
            try:
                problems = verify_chain(path)
            except (ScdaError, OSError, ValueError) as e:
                _err(f"{path}: {e}")
                status = 1
                continue
            for p in problems:
                print(f"{path}: {p}")
            if problems:
                status = 1
                print(f"{path}: FAILED ({len(problems)} problem"
                      f"{'s' if len(problems) != 1 else ''})")
            else:
                print(f"{path}: verified (chunk digests match across "
                      f"the chain)")
        return status
    for f in args.files:
        # Erasure-code health of sharded sets, named per shard — the
        # one-line answer to "is this checkpoint still restorable".
        if is_sharded_manifest(f):
            from repro_torch.checkpoint import redundancy as red
            try:
                health, lost_data, lost_parity = red.set_health(f)
            except (ScdaError, OSError, ValueError):
                continue  # per-file loop below reports the breakage
            if health != "clean":
                lost = ", ".join(lost_data + lost_parity)
                print(f"{f}: set health: {health} — lost {lost}")
                if health == "unrecoverable":
                    status = 1
    for path in [p for f in args.files for p in _expand_set(f)]:
        sidecar = path + SIDECAR_SUFFIX
        try:
            idx = ScdaIndex.load_sidecar(path)
        except (ScdaError, OSError) as e:
            _err(f"{path}: cannot load checksum manifest {sidecar}: {e} "
                 f"(write one with: scdatool index --checksums)")
            status = 1
            continue
        try:
            problems = idx.verify_checksums()
        except (ScdaError, OSError) as e:
            _err(f"{path}: {e}")
            status = 1
            continue
        for p in problems:
            print(f"{path}: {p}")
        if problems:
            status = 1
            print(f"{path}: FAILED ({len(problems)} problem"
                  f"{'s' if len(problems) != 1 else ''})")
        else:
            print(f"{path}: verified ({len(idx)} sections, "
                  f"payload checksums match)")
    return status


# -- copy / append -----------------------------------------------------------

def _pump_sections(r, w, idx: ScdaIndex, recompress: bool,
                   decompress: bool) -> int:
    """Re-emit every section of ``r`` (indexed by ``idx``) through writer
    ``w`` — the shared engine of ``copy`` (mode 'w') and ``append``
    (mode 'a'); both produce sections byte-equivalent to writing the
    logical content directly."""
    for i, e in enumerate(idx):
        hdr = r.seek_section(i)
        if recompress:
            enc = True
        elif decompress:
            enc = False
        else:
            enc = e.decoded   # preserve each section's encoding
        if hdr.type == "I":
            w.write_inline(hdr.user_string, r.read_inline_data())
        elif hdr.type == "B":
            w.write_block(hdr.user_string, r.read_block_data(),
                          encode=enc)
        elif hdr.type == "A":
            data = r.read_array_data([hdr.N])
            w.write_array(hdr.user_string, data, [hdr.N], hdr.E,
                          indirect=True, encode=enc)
        else:  # V
            sizes = r.read_varray_sizes([hdr.N])
            data = r.read_varray_data([hdr.N], sizes)
            w.write_varray(hdr.user_string, data, [hdr.N], sizes,
                           encode=enc)
    return len(idx)


def cmd_copy(args) -> int:
    with fopen_read(None, args.src) as r:
        idx = r.index()
        with fopen_write(None, args.dst, user_string=r.user_string,
                         vendor=r.vendor) as w:
            _pump_sections(r, w, idx, args.recompress, args.decompress)
    if args.index:
        ScdaIndex.build(args.dst).write_sidecar()
    print(f"copied {len(idx)} sections: {args.src} -> {args.dst}")
    return 0


def cmd_append(args) -> int:
    """Grow DST in place: every section of each SRC is re-emitted through
    a mode-'a' writer, tail-validated first, so the result is identical
    to having written DST's and SRC's sections in one serial session.
    An existing ``.scdax`` sidecar is refreshed incrementally and
    atomically (suffix-only scan; payload CRCs are computed for the new
    sections iff the old sidecar recorded them, so ``scdatool verify``
    keeps passing)."""
    total = 0
    with fopen_append(None, args.dst, recover=args.recover) as w:
        base = w.base_sections
        for src in args.srcs:
            with fopen_read(None, src) as r:
                total += _pump_sections(r, w, r.index(),
                                        args.recompress, args.decompress)
    if args.index:
        ScdaIndex.build(args.dst).write_sidecar()
        refreshed = True
    else:
        refreshed = ScdaIndex.refresh_sidecar(args.dst) is not None
    print(f"appended {total} sections onto {args.dst} "
          f"({base} -> {base + total}"
          f"{', sidecar refreshed' if refreshed else ''})")
    return 0


# -- tail --------------------------------------------------------------------

def cmd_tail(args) -> int:
    """Print journal records (``repro.journal``) as JSON lines.

    Default: dump every record currently in the file and exit (the CI
    smoke mode).  ``--follow`` keeps polling: the index is extended
    incrementally (suffix-only scans) and records from newly landed
    sections stream out as the producer flushes them — ``tail -f`` for
    an archive that is being journaled."""
    from repro_torch.journal import iter_records
    idx = ScdaIndex.cached(args.file, write=False)
    shown = 0
    for _, rec in iter_records(args.file, index=idx):
        print(json.dumps(rec, sort_keys=True))
        shown += 1
    if not args.follow:
        if not shown:
            _err(f"{args.file}: no journal records")
        return 0
    try:
        seen = len(idx.entries)
        while True:
            sys.stdout.flush()
            time.sleep(args.interval)
            if idx.staleness() == "fresh":
                continue
            try:
                idx = idx.extend()  # suffix scan; full rebuild on rewrite
                # A rebuild that SHRANK the table means the file was
                # rewritten (or a torn tail was truncated): re-stream the
                # new file's records rather than skipping unseen ones.
                if len(idx.entries) < seen:
                    seen = 0
                for _, rec in iter_records(args.file, start_section=seen,
                                           index=idx):
                    print(json.dumps(rec, sort_keys=True))
                seen = len(idx.entries)
            except (ScdaError, OSError):
                # tail -f semantics: a mid-append torn tail, a retention
                # delete, or a rewrite in progress is a reason to wait
                # for the next poll, not to die.
                continue
    except KeyboardInterrupt:
        return 0


# -- stats -------------------------------------------------------------------

def _entry_logical_bytes(r, e) -> Optional[int]:
    """Decoded (logical) payload size of one indexed section.

    Raw kinds carry it in the entry itself; ``zB``/``zA`` record it as
    ``raw_E`` / ``N*E``; ``zV`` needs the decoded element sizes, which
    live in the on-disk ``U`` count-entry table (parsed, not decoded)."""
    if e.kind in ("I", "B", "V"):
        return e.payload_bytes
    if e.kind in ("A", "zA"):
        return e.N * e.E
    if e.kind == "zB":
        return e.raw_E
    if e.kind == "zV":
        return sum(r._parse_entries(e.entries_start, 0, e.N, b"U"))
    return None


def cmd_stats(args) -> int:
    """Size/compression accounting and Chrome-trace summarization.

    With FILEs: a per-section table of stored (on-disk payload) vs
    logical (decoded) bytes and the compression ratio, from the seekable
    index — §3-encoded sections report real ratios, raw ones 1.00.
    Sharded-set manifests expand to the whole set.  With ``--trace``,
    summarizes a Chrome trace captured via ``REPRO_SCDA_TRACE`` (or
    ``benchmarks/run.py --trace``): per-stage time breakdown, syscall
    counts, bytes moved, MB/s.
    """
    if not args.files and not args.trace:
        _err("nothing to do: pass FILEs and/or --trace TRACE.json")
        return 2
    status = 0
    docs = []
    for path in [p for f in args.files for p in _expand_set(f)]:
        try:
            with fopen_read(None, path) as r:
                idx = r.index()
                rows = []
                for i, e in enumerate(idx):
                    logical = _entry_logical_bytes(r, e)
                    stored = e.payload_bytes
                    ratio = (logical / stored
                             if logical is not None and stored else None)
                    rows.append({"sec": i, "kind": e.kind,
                                 "stored": stored, "logical": logical,
                                 "ratio": ratio,
                                 "user": _printable(e.user_string)})
        except (ScdaError, OSError, ValueError) as e:
            _err(f"{path}: {e}")
            status = 1
            continue
        stored_t = sum(row["stored"] for row in rows)
        logical_t = sum(row["logical"] or 0 for row in rows)
        doc = {"file": path, "bytes": idx.file_size, "sections": rows,
               "stored_bytes": stored_t, "logical_bytes": logical_t,
               "ratio": (logical_t / stored_t) if stored_t else None}
        if args.json:
            docs.append(doc)
            continue
        print(f"# {path}: {len(idx)} sections, {idx.file_size} bytes on "
              f"disk, payload {stored_t} stored / {logical_t} logical"
              + (f" (ratio {logical_t / stored_t:.2f})" if stored_t
                 else ""))
        print(f"{'sec':>4} {'kind':>4} {'stored':>12} {'logical':>12} "
              f"{'ratio':>6}  user string")
        for row in rows:
            ratio = (f"{row['ratio']:.2f}" if row["ratio"] is not None
                     else "-")
            logical = row["logical"] if row["logical"] is not None else "-"
            print(f"{row['sec']:>4} {row['kind']:>4} {row['stored']:>12} "
                  f"{logical:>12} {ratio:>6}  {row['user']}")
    trace_doc = None
    if args.trace:
        try:
            summary = _trace.summarize_chrome(
                _trace.load_chrome(args.trace))
        except (OSError, ValueError) as e:
            _err(f"{args.trace}: {e}")
            return 1
        if args.json:
            trace_doc = summary
        else:
            print(f"# {args.trace}:")
            for line in _trace.format_summary(summary):
                print(line)
    if args.json:
        out = {"files": docs}
        if trace_doc is not None:
            out["trace"] = trace_doc
        print(json.dumps(out, indent=1, sort_keys=True))
    return status


# -- diff --------------------------------------------------------------------

_DIFF_CHUNK = 1 << 20  # bounded-memory payload comparison


def _stream_diff(ba, bb, off_a: int, off_b: int, na: int,
                 nb: int) -> Optional[int]:
    """First differing byte offset of two on-disk ranges, or None."""
    n = min(na, nb)
    pos = 0
    while pos < n:
        take = min(_DIFF_CHUNK, n - pos)
        ca = ba.pread(off_a + pos, take)
        cb = bb.pread(off_b + pos, take)
        if ca != cb:
            for i, (x, y) in enumerate(zip(ca, cb)):
                if x != y:
                    return pos + i
            return pos + min(len(ca), len(cb))
        pos += take
    return None if na == nb else n


def _fast_section_diff(ra, rb, ea, eb):
    """Same-kind fast path comparing count-entry values and payload data
    bytes (never headers or padding, whose bytes are line-break-style
    dependent).  Returns ``("equal", None)``, ``("differs", detail)``, or
    ``("decode", None)`` when raw encoded bytes differ but content may
    still match (zlib level / style) and a decoded pass must decide."""
    ba, bb = ra._backend, rb._backend
    kind = ea.kind
    if kind in ("I", "B", "A"):
        at = _stream_diff(ba, bb, ea.data_start, eb.data_start,
                          ea.payload_bytes, eb.payload_bytes)
        return ("equal", None) if at is None else \
            ("differs", f"payload differs (first at byte {at})")
    if kind == "V":
        sa = ra._parse_entries(ea.entries_start, 0, ea.N, b"E")
        sb = rb._parse_entries(eb.entries_start, 0, eb.N, b"E")
        if sa != sb:
            first = next(j for j, (x, y) in enumerate(zip(sa, sb))
                         if x != y)
            return ("differs",
                    f"element sizes differ (first at element {first})")
        at = _stream_diff(ba, bb, ea.data_start, eb.data_start,
                          ea.payload_bytes, eb.payload_bytes)
        return ("equal", None) if at is None else \
            ("differs", f"payload differs (first at byte {at})")
    if kind == "zV":
        ua = ra._parse_entries(ea.entries_start, 0, ea.N, b"U")
        ub = rb._parse_entries(eb.entries_start, 0, eb.N, b"U")
        if ua != ub:
            first = next(j for j, (x, y) in enumerate(zip(ua, ub))
                         if x != y)
            return ("differs",
                    f"element sizes differ (first at element {first})")
    # encoded kinds: identical compressed geometry + bytes prove equality;
    # anything else needs the decoded pass.
    if kind == "zB" and ea.raw_E != eb.raw_E:
        return ("decode", None)
    if kind in ("zA", "zV"):
        ca = ra._parse_entries(ea.v_entries_start, 0, ea.N, b"E")
        cb = rb._parse_entries(eb.v_entries_start, 0, eb.N, b"E")
        if ca != cb:
            return ("decode", None)
    start_a = ea.v_data_start if kind in ("zA", "zV") else ea.data_start
    start_b = eb.v_data_start if kind in ("zA", "zV") else eb.data_start
    at = _stream_diff(ba, bb, start_a, start_b,
                      ea.payload_bytes, eb.payload_bytes)
    return ("equal", None) if at is None else ("decode", None)


def _logical_payload_diff(ra, rb, i) -> Optional[str]:
    """Decoded (logical) payload comparison of section ``i`` of both
    archives — element batches through the pipelined ``read_batch``,
    bounded memory, never a full restore.  Encoded sections compare by
    content, so a recompressed copy is still equal.  Returns a
    human-readable difference, or None if equal."""
    ea = ra.index().entries[i]
    if ea.type == "I":
        ra.seek_section(i)
        rb.seek_section(i)
        if ra.read_inline_data() != rb.read_inline_data():
            return "inline data differs"
        return None
    if ea.type == "B":
        ra.seek_section(i)
        rb.seek_section(i)
        if ra.read_block_data() != rb.read_block_data():
            return "block payload differs"
        return None
    # A/V (raw or encoded): element windows via the batched reader — ONE
    # read_batch per archive (tables parsed once, windows streamed by the
    # pipeline in offset order with bounded in-flight memory), not one
    # call per window, which would re-parse the count-entry tables per
    # step (quadratic in N).
    if ea.type == "A":
        step = max(1, _DIFF_CHUNK // max(1, ea.E))
        windows = [(start, min(step, ea.N - start))
                   for start in range(0, ea.N, step)]
    else:
        # Varray elements are variable-size, so windows are bounded by
        # bytes, not element count — a fixed count per window would make
        # diff's memory proportional to the largest elements.
        sizes = ra._parse_entries(ea.entries_start, 0, ea.N,
                                  b"U" if ea.kind == "zV" else b"E")
        windows = []
        start = acc = 0
        for j, s in enumerate(sizes):
            acc += s
            if acc >= _DIFF_CHUNK:
                windows.append((start, j + 1 - start))
                start, acc = j + 1, 0
        if start < ea.N:
            windows.append((start, ea.N - start))
    reqs = [(i, [w]) for w in windows]
    for (pos, res_a), (_, res_b) in zip(ra.read_batch(reqs),
                                        rb.read_batch(reqs)):
        start, n = windows[pos]
        if ea.type == "A":
            wa, wb = res_a[0], res_b[0]
            if wa != wb:
                E = max(1, ea.E)
                first = next(j for j in range(n)
                             if wa[j * E:(j + 1) * E]
                             != wb[j * E:(j + 1) * E])
                return f"payload differs (first at element {start + first})"
        else:
            for j, (x, y) in enumerate(zip(res_a, res_b)):
                if x != y:
                    return (f"payload differs (first at element "
                            f"{start + j})")
    return None


def cmd_squash(args) -> int:
    """Materialize a delta chain into one self-contained archive —
    byte-identical to a direct full (hash-recording) save of the same
    state, so the output is itself a usable delta base."""
    from repro_torch.checkpoint.delta import squash
    src = _checkpoint_summary(args.src)
    if (src or {}).get("format") == "repro-scda-sharded":
        from repro_torch.checkpoint import sharding
        try:
            depth = sharding.chain_depth(
                sharding.load_set(args.src, verify=False))
        except (ScdaError, OSError, ValueError):
            depth = 0
    else:
        depth = int(((src or {}).get("delta") or {}).get("depth", 0))
    doc = squash(args.src, args.dst)
    if args.index:
        ScdaIndex.build(args.dst).write_sidecar()
    print(f"squashed {args.src} -> {args.dst} "
          f"({len(doc.get('leaves', []))} leaves, chain depth {depth} -> 0)")
    return 0


def cmd_diff(args) -> int:
    """Leaf-wise archive comparison via the seekable indexes.

    Section tables, user strings, and per-leaf payload bytes are compared
    without a full restore: raw extents first (cheap), decoded payloads
    only when the encodings differ (so a recompressed copy still compares
    equal leaf-wise).  Exit 1 on the first difference; ``--all`` keeps
    going and lists every one.

    ``--logical`` compares two *checkpoints* by the state they encode,
    resolving delta chains — a delta checkpoint equals the full (or
    squashed) checkpoint of the same state even though their section
    tables differ completely.
    """
    if args.logical:
        from repro_torch.checkpoint.delta import checkpoint_diff
        diffs_ = checkpoint_diff(args.a, args.b)
        for d in diffs_:
            print(d)
        if diffs_:
            print(f"{args.a} and {args.b} differ logically "
                  f"({len(diffs_)} difference"
                  f"{'s' if len(diffs_) != 1 else ''} listed)")
            return 1
        print(f"{args.a} and {args.b} encode the same checkpoint state")
        return 0
    diffs = 0

    def report(msg: str) -> None:
        nonlocal diffs
        diffs += 1
        print(msg)

    with fopen_read(None, args.a) as ra, fopen_read(None, args.b) as rb:
        ia, ib = ra.index(), rb.index()
        if ra.user_string != rb.user_string:
            report(f"file user string differs: "
                   f"{_printable(ra.user_string)!r} vs "
                   f"{_printable(rb.user_string)!r}")
            if not args.all:
                return 1
        if len(ia) != len(ib):
            report(f"section count differs: {len(ia)} vs {len(ib)}")
            if not args.all:
                return 1
        for i in range(min(len(ia), len(ib))):
            ea, eb = ia.entries[i], ib.entries[i]
            name = _printable(ea.user_string)
            if (ea.type, ea.user_string, ea.N, ea.E) != \
                    (eb.type, eb.user_string, eb.N, eb.E):
                report(f"section {i} ({name!r}): headers differ: "
                       f"{ea.type} {_printable(ea.user_string)!r} "
                       f"N={ea.N} E={ea.E} vs "
                       f"{eb.type} {_printable(eb.user_string)!r} "
                       f"N={eb.N} E={eb.E}")
                if not args.all:
                    return 1
                continue
            if ea.kind == eb.kind:
                # Same physical encoding: compare count-entry values and
                # raw payload bytes without decoding anything.
                verdict, detail = _fast_section_diff(ra, rb, ea, eb)
                if verdict == "equal":
                    continue
                if verdict == "differs":
                    report(f"section {i} ({name!r}): {detail}")
                    if not args.all:
                        return 1
                    continue
                # "decode": raw encoded bytes differ but content may not
                # (zlib level, line-break style) — decide logically.
            msg = _logical_payload_diff(ra, rb, i)
            if msg is not None:
                report(f"section {i} ({name!r}): {msg}")
                if not args.all:
                    return 1
    if diffs:
        print(f"{args.a} and {args.b} differ ({diffs} difference"
              f"{'s' if diffs != 1 else ''} listed)")
        return 1
    print(f"{args.a} and {args.b} match leaf-wise")
    return 0


# -- entry point -------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="scdatool",
        description="inspect, validate, index, and rewrite scda archives")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("ls", help="list the section table")
    p.add_argument("file")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output (includes checkpoint and "
                        "delta-chain metadata when present)")
    p.set_defaults(fn=cmd_ls)

    p = sub.add_parser("cat", help="dump one section's decoded payload")
    p.add_argument("file")
    p.add_argument("section", help="section number or user string")
    p.add_argument("--element", type=int, default=None,
                   help="single varray element index")
    p.add_argument("--extent", action="store_true",
                   help="dump the raw on-disk extent (headers included)")
    p.set_defaults(fn=cmd_cat)

    p = sub.add_parser("fsck", help="validate file structure")
    p.add_argument("files", nargs="+")
    p.add_argument("--fast", action="store_true",
                   help="skip payload decompression checks")
    p.add_argument("--no-sidecar", action="store_true",
                   help="do not verify .scdax sidecars")
    p.add_argument("--strict", action="store_true",
                   help="warnings also fail")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="print errors only")
    p.add_argument("--timing", action="store_true",
                   help="print per-phase wall time and bytes scanned "
                        "after the check")
    p.set_defaults(fn=cmd_fsck)

    p = sub.add_parser("repair",
                       help="salvage the valid prefix of damaged archives "
                            "(quarantines the torn tail, rebuilds sidecars; "
                            "sharded sets report per-shard damage)")
    p.add_argument("files", nargs="+")
    p.add_argument("-n", "--dry-run", action="store_true",
                   help="report what would be repaired without touching "
                        "anything (exit 1 if damage found)")
    p.add_argument("--no-quarantine", action="store_true",
                   help="discard the damaged tail instead of preserving it "
                        "in <file>.quarantine-<offset>")
    p.add_argument("--no-sidecar", action="store_true",
                   help="do not rebuild .scdax sidecars after the repair")
    p.add_argument("--rebuild", action="store_true",
                   help="re-materialize lost or rewritten shards of a "
                        "parity-carrying set from the survivors "
                        "(byte-identical, content-id verified)")
    p.set_defaults(fn=cmd_repair)

    p = sub.add_parser("index", help="write (or --check) .scdax sidecars")
    p.add_argument("files", nargs="+")
    p.add_argument("--check", action="store_true",
                   help="verify existing sidecars instead of writing")
    p.add_argument("--checksums", action="store_true",
                   help="also record per-section payload CRC32s "
                        "(enables 'scdatool verify')")
    p.set_defaults(fn=cmd_index)

    p = sub.add_parser("verify",
                       help="check archives against their sidecar "
                            "checksum manifests (no reference copy)")
    p.add_argument("files", nargs="+")
    p.add_argument("--chain", action="store_true",
                   help="digest-verify checkpoint chunk content across the "
                        "delta chain (CRC32 + SHA-256; follows base "
                        "archives)")
    p.add_argument("--timing", action="store_true",
                   help="print per-phase wall time and bytes scanned "
                        "after the check")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("copy", help="rewrite an archive section by section")
    p.add_argument("src")
    p.add_argument("dst")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--recompress", action="store_true",
                   help="§3-encode every B/A/V payload")
    g.add_argument("--decompress", action="store_true",
                   help="store every payload raw")
    p.add_argument("--index", action="store_true",
                   help="also write the destination's .scdax sidecar")
    p.set_defaults(fn=cmd_copy)

    p = sub.add_parser("diff",
                       help="compare two archives leaf-wise via the index")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--all", action="store_true",
                   help="list every difference instead of stopping at the "
                        "first")
    p.add_argument("--logical", action="store_true",
                   help="compare checkpoints by encoded state, resolving "
                        "delta chains")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("squash",
                       help="materialize a delta checkpoint chain into one "
                            "self-contained archive")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--index", action="store_true",
                   help="also write the destination's .scdax sidecar")
    p.set_defaults(fn=cmd_squash)

    p = sub.add_parser("append",
                       help="append SRC archives' sections onto DST in "
                            "place (mode 'a'; tail-validated)")
    p.add_argument("dst")
    p.add_argument("srcs", nargs="+", metavar="src")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--recompress", action="store_true",
                   help="§3-encode every appended B/A/V payload")
    g.add_argument("--decompress", action="store_true",
                   help="store every appended payload raw")
    p.add_argument("--recover", action="store_true",
                   help="truncate a torn tail back to the last valid "
                        "section boundary instead of failing")
    p.add_argument("--index", action="store_true",
                   help="(re)write the destination's .scdax sidecar even "
                        "if none exists")
    p.set_defaults(fn=cmd_append)

    p = sub.add_parser("tail",
                       help="print journal records as JSON lines; "
                            "-f follows new sections as they land")
    p.add_argument("file")
    p.add_argument("-f", "--follow", action="store_true",
                   help="poll for appended journal sections forever")
    p.add_argument("--interval", type=float, default=1.0,
                   help="poll interval for --follow (seconds, default 1)")
    p.set_defaults(fn=cmd_tail)

    p = sub.add_parser("stats",
                       help="per-section stored/logical bytes and "
                            "compression ratios; --trace summarizes a "
                            "Chrome trace")
    p.add_argument("files", nargs="*")
    p.add_argument("--trace", metavar="TRACE.json", default=None,
                   help="summarize a Chrome trace captured with "
                        "REPRO_SCDA_TRACE (per-stage time, syscalls, "
                        "bytes, MB/s)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    p.set_defaults(fn=cmd_stats)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:  # | head etc.
        return 0
    except (ScdaError, OSError, ValueError) as e:
        _err(str(e))
        return 1


if __name__ == "__main__":
    sys.exit(main())
