"""Structural validation of scda files (``scdatool fsck``).

Walks the section stream front to back, re-deriving every offset the way a
reader must, and checks everything the format makes checkable:

* file header: magic bytes, version range, vendor/user padding;
* section headers and count entries, including the per-element entry
  tables of V sections with STRICT letter enforcement (the normal skip
  path is deliberately lenient there, §A.5.1);
* §3 compression framing: base64 line geometry, the 'z' marker, the
  deflate stream's adler32, and the redundant size checks — every
  compressed payload is actually inflated (unless ``deep=False``);
* truncation: no section may extend past end of file, and the final
  section's padding must land exactly ON end of file (trailing garbage
  fails the next header parse and is reported as corruption at the
  EXACT byte offset where validation failed — the reader attaches
  ``ScdaError.offset`` to parse failures, so a valid prefix followed by
  garbage points at the failing entry/byte, not just at the section
  boundary; mode-'a' appends rely on this to make tail-validation
  errors actionable);
* data padding: the length is normative and enforced by offset
  arithmetic; the pad *bytes* are only advisory per §2.1.2 ("may consist
  of p arbitrary bytes"), so a pad matching neither the Unix nor the
  MIME discipline is reported as a warning, not an error;
* an existing ``.scdax`` sidecar, when present, is deep-verified against
  the file (stale sidecars are findings too);
* delta checkpoints (manifest version 2): every referenced base archive
  must exist, parse, and still match the content id recorded when the
  delta was saved — a deleted or rewritten base makes the delta
  unrestorable and is an error; with ``deep=True`` every chunk across
  the chain is additionally digest-verified (CRC32 + SHA-256);
* sharded-set manifests: every shard the manifest names must exist,
  match its recorded byte size and pinned content id, and pass its own
  fsck (recursively, same depth) — one fsck of the manifest validates
  the whole multi-file checkpoint.

Corruption cannot be resynced in a stream format — the walk stops at the
first structural error; warnings accumulate.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

from repro_torch.core import spec
from repro_torch.core.errors import ScdaError
from repro_torch.core.index import SIDECAR_SUFFIX, ScdaIndex
from repro_torch.core.io_backend import FileBackend, fsync_dir
from repro_torch.core.reader import fopen_read
from repro_torch.core.writer import validate_tail


@dataclasses.dataclass
class Finding:
    severity: str            # "error" | "warning"
    offset: int              # byte offset the finding anchors to
    section: Optional[int]   # logical section number, None for file-level
    message: str

    def __str__(self) -> str:
        where = f"section {self.section}" if self.section is not None \
            else "file"
        return f"{self.severity}: @{self.offset} ({where}): {self.message}"


def _payload_bytes(r, p) -> int:
    """On-disk data bytes of the pending section (strict-parses V tables)."""
    if p.kind == "I":
        return spec.INLINE_DATA_BYTES
    if p.kind == "B":
        return p.header.E
    if p.kind == "zB":
        return p.raw_E
    if p.kind == "A":
        return p.header.N * p.header.E
    entries = p.entries_start if p.kind == "V" else p.v_entries_start
    return sum(r._parse_entries(entries, 0, p.header.N, b"E"))


def _check_section(r, deep: bool) -> None:
    """Consume the pending section, validating as much as ``deep`` asks."""
    p = r._pending
    kind = p.kind
    N = p.header.N
    if kind == "I":
        r.read_inline_data()
    elif kind in ("B", "zB"):
        if deep:
            r.read_block_data()       # zB: inflate + adler32 + size check
        else:
            r.skip_data()
    elif kind == "A":
        r.skip_data()                 # raw payload: bounds are the check
    elif kind == "zA":
        if deep:
            r.read_array_data([N])    # inflate every element, verify E
        else:
            r.skip_data()
    elif kind == "V":
        r.skip_data()
    else:  # zV
        sizes = r.read_varray_sizes([N])   # strict 'U' entry parse
        if deep:
            r.read_varray_data([N], sizes)  # inflate, verify per-element U
        else:
            r.skip_data()


def _expected_extent(p, payload: int) -> int:
    """The section's on-disk size from spec arithmetic alone.

    Cross-checks the reader's cursor bookkeeping against an independent
    derivation — the two agreeing is a structural invariant of the format.
    """
    kind, hdr = p.kind, p.header
    if kind == "I":
        return spec.inline_section_bytes()
    if kind == "B":
        return spec.block_section_bytes(hdr.E)
    if kind == "zB":
        return spec.encoded_block_section_bytes(p.raw_E)
    if kind == "A":
        return spec.array_section_bytes(hdr.N, hdr.E)
    if kind == "V":
        return spec.varray_section_bytes(hdr.N, payload)
    if kind == "zA":
        return spec.encoded_array_section_bytes(hdr.N, payload)
    return spec.encoded_varray_section_bytes(hdr.N, payload)


def _pad_warning(backend, kind: str, data_region: int, payload: int,
                 end: int) -> Optional[str]:
    """Check the pad bytes against both canonical styles (advisory)."""
    if kind == "I":
        return None  # inline sections carry exactly 32 bytes, no padding
    pad = backend.pread(data_region + payload, end - data_region - payload)
    last = backend.pread(data_region + payload - 1, 1)[0] if payload else None
    for style in (spec.UNIX, spec.MIME):
        if pad == spec.pad_data(payload, last, style):
            return None
    return (f"data padding matches neither Unix nor MIME style "
            f"(legal per §2.1.2, but unusual): {pad[:16]!r}")


def _read_checkpoint_doc(path: str):
    """The repro-checkpoint manifest of ``path`` (flat or sharded-set),
    or None if it has no manifest section.  Reads only the manifest
    block (no jax, no leaf payloads) — fsck stays cheap on
    non-checkpoint archives."""
    from repro_torch.checkpoint import manifest as mf
    with fopen_read(None, path) as r:
        idx = r.index()
        sec = idx.find(mf.MANIFEST_USER_STRING)
        if sec >= 0:
            r.seek_section(sec)
            return mf.parse(r.read_block_data())
        sec = idx.find(mf.SHARDS_MANIFEST_USER_STRING)
        if sec >= 0:
            r.seek_section(sec)
            return mf.parse_sharded(r.read_block_data())
        return None


def _check_delta_chain(path: str, deep: bool,
                       findings: List[Finding]) -> None:
    """Chain-level findings for delta checkpoints.

    A structurally valid delta archive is still unrestorable if any base
    it references was deleted or rewritten in place — those are errors
    anchored at the manifest, not at a byte of this file.  ``deep``
    additionally digest-verifies every chunk across the chain.
    """
    from repro_torch.checkpoint import manifest as mf
    try:
        doc = _read_checkpoint_doc(path)
    except (ScdaError, OSError, ValueError):
        return  # not a readable checkpoint: nothing chain-level to check
    if not doc or not doc.get("delta"):
        return
    base_dir = os.path.dirname(os.path.abspath(path))
    ok = True
    for k, b in enumerate(doc["delta"].get("bases", []), start=1):
        name = b.get("file", "")
        bpath = os.path.join(base_dir, name)
        try:
            bdoc = _read_checkpoint_doc(bpath)
        except (ScdaError, OSError, ValueError) as e:
            findings.append(Finding(
                "error", 0, None, f"delta base #{k} {name!r}: {e}"))
            ok = False
            continue
        if bdoc is None:
            findings.append(Finding(
                "error", 0, None,
                f"delta base #{k} {name!r}: not a checkpoint archive"))
            ok = False
            continue
        got = mf.content_id(bdoc)
        if got != b.get("id"):
            findings.append(Finding(
                "error", 0, None,
                f"delta base #{k} {name!r}: content id {got} != recorded "
                f"{b.get('id')} — base rewritten since this delta was "
                f"saved"))
            ok = False
    if deep and ok:
        from repro_torch.checkpoint.delta import verify_chain
        try:
            for problem in verify_chain(path):
                findings.append(Finding("error", 0, None,
                                        f"chain: {problem}"))
        except (ScdaError, OSError, ValueError) as e:
            findings.append(Finding("error", 0, None, f"chain: {e}"))


def _check_sharded_set(path: str, deep: bool, check_sidecar: bool,
                       findings: List[Finding]) -> None:
    """Set-level findings for sharded checkpoint manifests.

    The manifest file itself is tiny and already walked; what can rot is
    the set it names — a shard deleted, truncated, or rewritten in place.
    ``verify_set`` reports those by shard name; every shard still on disk
    is then fsck'd recursively (same depth), so one ``scdatool fsck
    MANIFEST`` validates the whole checkpoint."""
    from repro_torch.checkpoint import manifest as mf, sharding
    try:
        with fopen_read(None, path) as r:
            if r.index().find(mf.SHARDS_MANIFEST_USER_STRING) < 0:
                return
    except (ScdaError, OSError):
        return
    for p in sharding.verify_set(path):
        findings.append(Finding("error", 0, None, f"set: {p}"))
    try:
        doc = sharding.read_sharded_manifest(path)
    except (ScdaError, OSError, ValueError):
        return  # verify_set already reported the manifest unreadable
    base = os.path.dirname(os.path.abspath(path))
    for k, srec in enumerate(doc.get("shards", [])):
        name = srec.get("file", "")
        spath = os.path.join(base, name)
        if not os.path.exists(spath):
            continue  # missing: already an error, named by verify_set
        for f in fsck_file(spath, deep=deep, check_sidecar=check_sidecar):
            findings.append(Finding(f.severity, f.offset, f.section,
                                    f"shard #{k} {name!r}: {f.message}"))
    for j, rec in enumerate((doc.get("parity") or {}).get("files", [])):
        name = rec.get("file", "")
        ppath = os.path.join(base, name)
        if not os.path.exists(ppath):
            continue  # missing: reported below via set health
        for f in fsck_file(ppath, deep=deep, check_sidecar=check_sidecar):
            findings.append(Finding(f.severity, f.offset, f.section,
                                    f"parity #{j} {name!r}: {f.message}"))
    # Erasure-code health: a finding names the verdict and the exact
    # shard files it rests on, so "is this checkpoint still restorable"
    # never requires reading the errors above back together.
    from repro_torch.checkpoint import redundancy as red
    health, lost_data, lost_parity = red.set_health(path, doc)
    lost = ", ".join(lost_data + lost_parity)
    if health == "degraded-recoverable":
        findings.append(Finding(
            "warning", 0, None,
            f"set health: degraded-recoverable — lost {lost}; every "
            f"leaf still restores through parity (rebuild with "
            f"`scdatool repair --rebuild`)"))
    elif health == "unrecoverable":
        findings.append(Finding(
            "error", 0, None,
            f"set health: unrecoverable — lost {lost} exceeds the "
            f"parity budget"))


def fsck_file(path: str, deep: bool = True,
              check_sidecar: bool = True) -> List[Finding]:
    """Validate ``path``; returns findings (empty = clean)."""
    findings: List[Finding] = []
    try:
        r = fopen_read(None, path)
    except ScdaError as e:
        findings.append(Finding("error", 0, None, str(e)))
        return findings
    with r:
        sec = 0
        while not r.at_eof:
            start = r.cursor
            try:
                r.read_section_header(decode=True)
                p = r._pending
                data_region = (p.v_data_start
                               if p.kind in ("zA", "zV") else p.data_start)
                payload = _payload_bytes(r, p)
                _check_section(r, deep)
                if r.cursor - start != _expected_extent(p, payload):
                    findings.append(Finding(
                        "error", start, sec,
                        f"section extent {r.cursor - start} != spec "
                        f"arithmetic {_expected_extent(p, payload)}"))
                    return findings
                warn = _pad_warning(r._backend, p.kind, data_region,
                                    payload, r.cursor)
                if warn:
                    findings.append(Finding("warning", data_region + payload,
                                            sec, warn))
            except ScdaError as e:
                # Anchor the finding at the exact failing byte when the
                # reader pinned one (malformed entry, EOF position, bad
                # header) — "trailing garbage exists" becomes "validation
                # failed at byte X, section started at Y".
                at = e.offset if e.offset is not None else start
                msg = str(e)
                if e.offset is not None and e.offset != start:
                    msg += (f" (validation failed at byte {e.offset}; "
                            f"section started at {start})")
                findings.append(Finding("error", at, sec, msg))
                return findings  # a stream format cannot resync
            sec += 1
    if check_sidecar and os.path.exists(path + SIDECAR_SUFFIX):
        try:
            ScdaIndex.load_sidecar(path).verify(deep=True)
        except ScdaError as e:
            findings.append(Finding("error", 0, None,
                                    f"sidecar {path + SIDECAR_SUFFIX}: {e}"))
    _check_delta_chain(path, deep, findings)
    _check_sharded_set(path, deep, check_sidecar, findings)
    return findings


# --------------------------------------------------------------------------
# Repair (``scdatool repair``)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RepairResult:
    """Outcome of :func:`repair_file` on one archive.

    ``action`` is one of ``"clean"`` (nothing to do), ``"repaired"``,
    ``"would-repair"`` (dry run found damage), or ``"unrecoverable"``
    (no valid prefix — e.g. a corrupt file header).
    """
    path: str
    action: str
    valid_bytes: int = 0         # prefix kept (the truncation point)
    sections: int = 0            # whole sections surviving the repair
    dropped_bytes: int = 0       # damaged tail removed (or would be)
    quarantine: Optional[str] = None  # where the damaged bytes went
    sidecar: Optional[str] = None     # rebuilt sidecar, if one existed
    detail: str = ""

    def __str__(self) -> str:
        s = f"{self.path}: {self.action}"
        if self.action == "clean":
            return s + f" ({self.sections} sections, {self.valid_bytes} bytes)"
        if self.action == "unrecoverable":
            return s + f": {self.detail}"
        if self.action in ("rebuilt", "would-rebuild"):
            return s + f": {self.detail} ({self.valid_bytes} bytes)"
        s += (f": kept {self.sections} sections / {self.valid_bytes} bytes, "
              f"dropped {self.dropped_bytes} damaged bytes at offset "
              f"{self.valid_bytes}")
        if self.quarantine:
            s += f" -> {self.quarantine}"
        if self.sidecar:
            s += f" (sidecar rebuilt: {self.sidecar})"
        return s


def repair_file(path: str, quarantine: bool = True, dry_run: bool = False,
                sidecar: bool = True) -> RepairResult:
    """Salvage the valid section prefix of a damaged archive.

    Reuses the mode-'a' tail validator with ``recover=True``: everything
    before the first structural failure is a complete, fsck-clean
    archive — the damaged tail is cut at that exact byte.  With
    ``quarantine`` the removed bytes are preserved verbatim in
    ``<path>.quarantine-<offset>`` (forensics, nothing is destroyed);
    with ``sidecar`` an existing ``.scdax`` is rebuilt to describe the
    repaired file (checksums preserved if the old one recorded them).
    ``dry_run`` reports what would happen without touching the file.
    """
    try:
        size = os.stat(path).st_size
    except OSError as e:
        return RepairResult(path, "unrecoverable", detail=str(e))
    try:
        tail = validate_tail(path, recover=True)
    except ScdaError as e:
        return RepairResult(path, "unrecoverable", detail=str(e),
                            dropped_bytes=size)
    if tail.truncate_to is None:
        return RepairResult(path, "clean", valid_bytes=tail.end,
                            sections=tail.sections)
    cut = tail.truncate_to
    res = RepairResult(path, "would-repair" if dry_run else "repaired",
                       valid_bytes=cut, sections=tail.sections,
                       dropped_bytes=size - cut)
    if dry_run:
        return res
    b = FileBackend(path, "a", create=False)
    try:
        if quarantine and size > cut:
            qpath = f"{path}.quarantine-{cut}"
            damaged = b.pread(cut, size - cut)
            with open(qpath, "wb") as qf:
                qf.write(damaged)
                qf.flush()
                os.fsync(qf.fileno())
            res.quarantine = qpath
        b.truncate(cut)
        b.fsync()
    finally:
        b.close()
    # The truncation (and the quarantine file) must survive a power cut
    # just like a commit would.
    fsync_dir(os.path.dirname(os.path.abspath(path)))
    if sidecar and os.path.exists(path + SIDECAR_SUFFIX):
        try:
            idx = ScdaIndex.refresh_sidecar(path)
            if idx is not None:
                res.sidecar = path + SIDECAR_SUFFIX
        except (ScdaError, OSError) as e:
            res.detail = f"sidecar rebuild failed: {e}"
    return res


def is_sharded_manifest(path: str) -> bool:
    """True when ``path``'s valid prefix contains a sharded-set manifest."""
    from repro_torch.checkpoint import manifest as mf
    try:
        with fopen_read(None, path) as r:
            try:
                idx = r.index()
            except ScdaError as e:
                if e.group != 1:
                    raise
                idx = ScdaIndex.build_prefix(r)
            return idx.find(mf.SHARDS_MANIFEST_USER_STRING) >= 0
    except (ScdaError, OSError):
        return False


def sibling_shards_exist(path: str) -> bool:
    """True when files named like shards of a set at ``path`` exist —
    how ``scdatool repair`` recognizes a sharded set whose manifest is
    too damaged for :func:`is_sharded_manifest` to say so."""
    from repro_torch.checkpoint import sharding
    d = os.path.dirname(os.path.abspath(path))
    mname = os.path.basename(path)
    stem = mname[:-len(".scda")] if mname.endswith(".scda") else mname
    try:
        siblings = os.listdir(d)
    except OSError:
        return False
    for f in siblings:
        m = sharding._SHARD_RE.match(f)
        if m and m.group("stem") == stem:
            return True
    return False


def repair_set(path: str, quarantine: bool = True, dry_run: bool = False,
               sidecar: bool = True,
               rebuild: bool = False) -> List[RepairResult]:
    """Repair a sharded checkpoint set, reporting per-shard damage.

    The manifest file is repaired first (its own tail can be torn), then
    every shard it names — a damaged shard is salvaged independently
    instead of the whole set being refused.  When the manifest itself is
    beyond tail-salvage, repair falls back to the surviving shard
    archives: each is repaired on its own and a fresh manifest is
    rebuilt from their headers (see :func:`_rebuild_set_manifest`).

    With ``rebuild`` (``scdatool repair --rebuild``) a missing or
    wrong-sized shard of a parity-carrying set is re-materialized in
    place from the survivors — byte-identical to the lost original,
    dir-fsynced, content-id-verified before the rename lands.  Without
    parity (or past the parity budget) those stay unrecoverable
    entries; the manifest is never rewritten to drop them (that would
    change what was committed).
    """
    from repro_torch.checkpoint import redundancy as red, sharding
    results = [repair_file(path, quarantine=quarantine, dry_run=dry_run,
                           sidecar=sidecar)]
    doc = None
    if results[0].action != "unrecoverable":
        try:
            doc = sharding.read_sharded_manifest(path)
        except (ScdaError, OSError, ValueError) as e:
            results[0].detail = f"manifest unreadable after repair: {e}"
    if doc is None:
        return _rebuild_set_manifest(path, quarantine=quarantine,
                                     dry_run=dry_run, sidecar=sidecar,
                                     results=results)
    base = os.path.dirname(os.path.abspath(path))
    for k, srec in enumerate(doc.get("shards", [])):
        name = srec.get("file", "")
        spath = os.path.join(base, name)
        lost = not os.path.exists(spath) \
            or os.path.getsize(spath) != srec.get("bytes")
        if lost and rebuild:
            try:
                size = red.rebuild_shard(path, doc, name, dry_run=dry_run)
                results.append(RepairResult(
                    spath, "would-rebuild" if dry_run else "rebuilt",
                    valid_bytes=size,
                    detail=f"shard #{k} reconstructed from surviving "
                           f"shards + parity"))
            except (ScdaError, OSError) as e:
                results.append(RepairResult(
                    spath, "unrecoverable", detail=f"shard #{k}: {e}"))
            continue
        if not os.path.exists(spath):
            results.append(RepairResult(
                spath, "unrecoverable",
                detail=f"shard #{k} named by the manifest is missing"
                       + ("" if not (doc.get("parity") or {})
                          else " (recoverable: rerun with --rebuild)")))
            continue
        r = repair_file(spath, quarantine=quarantine, dry_run=dry_run,
                        sidecar=sidecar)
        r.detail = (f"shard #{k}" + (f": {r.detail}" if r.detail else ""))
        results.append(r)
    for j, rec in enumerate((doc.get("parity") or {}).get("files", [])):
        name = rec.get("file", "")
        ppath = os.path.join(base, name)
        problems = red.verify_parity_file(ppath, rec)
        if not problems:
            results.append(RepairResult(
                ppath, "clean", valid_bytes=int(rec.get("bytes", 0)),
                detail=f"parity #{j}"))
            continue
        if rebuild:
            try:
                size = red.rebuild_shard(path, doc, name, dry_run=dry_run)
                results.append(RepairResult(
                    ppath, "would-rebuild" if dry_run else "rebuilt",
                    valid_bytes=size,
                    detail=f"parity #{j} recomputed from the data "
                           f"shards"))
            except (ScdaError, OSError) as e:
                results.append(RepairResult(
                    ppath, "unrecoverable", detail=f"parity #{j}: {e}"))
        else:
            results.append(RepairResult(
                ppath, "unrecoverable",
                detail=f"parity #{j}: {problems[0]} (recoverable: rerun "
                       f"with --rebuild)"))
    return results


def _rebuild_set_manifest(path: str, *, quarantine: bool, dry_run: bool,
                          sidecar: bool,
                          results: List[RepairResult]) -> List[RepairResult]:
    """Fallback for a sharded set whose MANIFEST is damaged beyond tail
    salvage: repair every sibling shard independently, then rebuild the
    manifest from the surviving shard headers.

    Everything the manifest records is re-derivable from the shards
    themselves — content ids and byte sizes from the repaired files,
    leaf placement from each shard's own manifest (ordered by
    ``(shard, index)``; the original global manifest order is gone, which
    is harmless: restore resolves leaves by name), the step from the
    status inline, the parity record from surviving parity meta blocks.
    Only set-level ``aux`` values are truly unrecoverable — they lived
    nowhere but the manifest — and are reported loudly.  Data shards
    missing from disk are reconstructed from parity first when the
    surviving rows cover them.
    """
    from repro_torch.checkpoint import manifest as mf, redundancy as red, sharding
    d = os.path.dirname(os.path.abspath(path))
    mname = os.path.basename(path)
    stem = mname[:-len(".scda")] if mname.endswith(".scda") else mname
    shard_names: dict = {}
    n = None
    for f in sorted(os.listdir(d)):
        m = sharding._SHARD_RE.match(f)
        if m and m.group("stem") == stem:
            shard_names[int(m.group("k"))] = f
            n = int(m.group("n"))
    if n is None:
        results[0].action = "unrecoverable"
        results[0].detail += ("; no sibling shard files found — the "
                              "manifest cannot be rebuilt")
        return results
    # Surviving parity rows, keyed by row index j (position == j in the
    # manifest record, which is what the reconstructor checks against).
    parity_meta: dict = {}
    m_rows = 0
    for f in sorted(os.listdir(d)):
        g = red._PARITY_RE.match(f)
        if not g or g.group("stem") != stem:
            continue
        m_rows = max(m_rows, int(g.group("m")))
        try:
            meta = red.read_parity_meta(os.path.join(d, f))
        except (ScdaError, OSError, ValueError):
            continue
        if meta.get("n") == n:
            parity_meta[int(meta["j"])] = (f, meta)
    for k in sorted(shard_names):
        r = repair_file(os.path.join(d, shard_names[k]),
                        quarantine=quarantine, dry_run=dry_run,
                        sidecar=sidecar)
        r.detail = (f"shard #{k}" + (f": {r.detail}" if r.detail else ""))
        results.append(r)
    missing = [k for k in range(n) if k not in shard_names]
    if missing and parity_meta:
        # Parity meta records every shard's name and size — enough to
        # reconstruct the lost byte streams before reading any headers.
        meta = parity_meta[sorted(parity_meta)[0]][1]
        sizes = meta.get("sizes", [])
        names = meta.get("shards", [])
        pseudo = {
            "shards": [{"file": nm, "bytes": sz}
                       for nm, sz in zip(names, sizes)],
            "parity": {"code": meta.get("code"), "m": meta.get("m"),
                       "length": meta.get("length"),
                       "files": [
                           {"file": parity_meta[j][0],
                            "id": red.parity_id(parity_meta[j][1])}
                           if j in parity_meta else
                           {"file": red.parity_file(path, j,
                                                    int(meta.get("m", 0))),
                            "id": ""}
                           for j in range(int(meta.get("m", 0)))]},
        }
        for k in missing:
            name = names[k] if k < len(names) else \
                os.path.basename(sharding.shard_file(path, k, n))
            spath = os.path.join(d, name)
            try:
                recon = red.SetReconstructor(path, pseudo, lost=(name,))
            except (ScdaError, OSError) as e:
                results.append(RepairResult(
                    spath, "unrecoverable", detail=f"shard #{k}: {e}"))
                continue
            try:
                size = recon.shard_size(name)
                if not dry_run:
                    tmp = spath + ".rebuild"
                    with open(tmp, "wb") as out:
                        step_bytes = 4 << 20
                        for off in range(0, size, step_bytes):
                            out.write(recon.read(
                                name, off, min(step_bytes, size - off)))
                        out.flush()
                        os.fsync(out.fileno())
                    os.replace(tmp, spath)
                    fsync_dir(d)
                    shard_names[k] = name
                results.append(RepairResult(
                    spath, "would-rebuild" if dry_run else "rebuilt",
                    valid_bytes=size,
                    detail=f"shard #{k} reconstructed from surviving "
                           f"shards + parity"))
            except (ScdaError, OSError) as e:
                results.append(RepairResult(
                    spath, "unrecoverable", detail=f"shard #{k}: {e}"))
            finally:
                recon.close()
        missing = [k for k in range(n) if k not in shard_names]
    if missing:
        results[0].action = "unrecoverable"
        results[0].detail += (
            f"; shard(s) {sorted(missing)} are gone and no parity row "
            f"covers them — the manifest cannot be rebuilt")
        return results
    shard_recs, placed, step = [], [], None
    for k in sorted(shard_names):
        spath = os.path.join(d, shard_names[k])
        try:
            sdoc = _read_checkpoint_doc(spath)
        except (ScdaError, OSError, ValueError) as e:
            results[0].action = "unrecoverable"
            results[0].detail += (f"; shard #{k} has no readable "
                                  f"checkpoint manifest ({e})")
            return results
        if sdoc is None:
            results[0].action = "unrecoverable"
            results[0].detail += (f"; shard #{k} is not a checkpoint "
                                  f"archive")
            return results
        if step is None:
            step = sdoc.get("step")
        shard_recs.append({"file": shard_names[k],
                           "id": mf.content_id(sdoc),
                           "bytes": int(os.path.getsize(spath)),
                           "leaves": len(sdoc.get("leaves", []))})
        for j, leaf in enumerate(sdoc.get("leaves", [])):
            placed.append({"name": leaf["name"], "shard": k, "index": j,
                           "nbytes": leaf["nbytes"]})
    doc = {"format": mf.SHARDED_FORMAT, "version": mf.SHARDED_VERSION,
           "step": step, "aux": {}, "shards": shard_recs,
           "leaves": placed}
    if parity_meta:
        j0 = sorted(parity_meta)[0]
        meta0 = parity_meta[j0][1]
        prec = {"code": meta0.get("code"), "m": int(meta0.get("m", 0)),
                "length": int(meta0.get("length", 0)), "files": []}
        for j in range(prec["m"]):
            if j in parity_meta:
                f, meta = parity_meta[j]
                prec["files"].append({
                    "file": f, "id": red.parity_id(meta),
                    "bytes": int(os.path.getsize(os.path.join(d, f)))})
            else:
                # The row is gone; record the expected name with its
                # real id unknown — repair --rebuild recomputes it.
                prec["files"].append({
                    "file": os.path.basename(
                        red.parity_file(path, j, prec["m"])),
                    "id": "", "bytes": 0})
        doc["parity"] = prec
    res = RepairResult(path, "would-rebuild" if dry_run else "rebuilt",
                       valid_bytes=0, sections=2,
                       detail="manifest rebuilt from shard headers; "
                              "set-level aux entries (if any) were only "
                              "recorded in the manifest and are LOST")
    if not dry_run:
        from repro_torch.core.writer import fopen_write
        tmp = path + ".rebuild"
        with fopen_write(None, tmp,
                         user_string=mf.SHARDS_FILE_USER_STRING,
                         sync=True) as f:
            f.write_inline(mf.STATUS_USER_STRING, mf.status_inline(step))
            f.write_block(mf.SHARDS_MANIFEST_USER_STRING,
                          mf.build_sharded(doc), E=None)
        os.replace(tmp, path)
        fsync_dir(d)
        res.valid_bytes = os.path.getsize(path)
    results[0] = res
    return results
