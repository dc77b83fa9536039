"""Multi-file sharded checkpoints — one manifest, N independent archives.
The port of the JAX package's ``repro/checkpoint/sharding.py``: a set
written here with the reference's vendor string is the one the reference
writes, file for file, and each package restores the other's sets.

Fleet-scale checkpoints outgrow single files and single filesystems; the
scda answer is to keep the format untouched and lift the paper's §2
partition-independence invariant one level up.  A sharded save splits
the leaf set deterministically across ``N`` ordinary scda checkpoint
archives (each written through the existing overlapped save engine, each
individually byte-identical to a serial ``save`` of its leaf subset) and
records the set in one small **manifest file** that is itself a valid
scda file — exactly like the ``.scdax`` sidecar:

    F  header (user string "repro ckpt-shards")
    I  "scda-ckpt status"       — same human-readable step line
    B  "scda-shards manifest"   — JSON: shard files + content ids +
                                  byte sizes, leaf→shard placement, aux

The per-shard digest tables live where they always did — in each shard's
own manifest (chunk CRC32 + SHA-256 tables when recorded) — and the set
manifest pins every shard by its deterministic
:func:`repro_torch.checkpoint.manifest.content_id`, so a shard rewritten in
place since the set was saved refuses loudly (CORRUPT_CHECKSUM) instead
of assembling silently wrong tensors.  Because shards are plain
checkpoints, delta chains compose: a sharded delta save pairs shard *k*
against the base's shard *k* (or against a single-file base), and every
shard archive resolves through the ordinary
:class:`repro_torch.checkpoint.delta.ChainResolver`.

``restore``/``restore_leaf``/``restore(like=)`` resolve the manifest
transparently (see the delegation hooks in
:mod:`repro_torch.checkpoint.pytree_io`) and open each needed shard in a
deterministic order; restored leaves land on ``device`` or on their
``like`` leaf's device.

Knobs: ``CheckpointManager(shards=N)`` or ``REPRO_SCDA_SHARDS=N``
(0 = classic single-file saves).  :mod:`repro_torch.checkpoint.pytree_io`
is imported lazily inside the restore/save bodies (it imports this
module).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.checkpoint import manifest as mf
from repro_torch.core import trace as _trace
from repro_torch.core.comm import Communicator, SerialComm
from repro_torch.core.errors import ScdaError, ScdaErrorCode
from repro_torch.core.io_backend import fsync_dir, replace_file
from repro_torch.core.reader import fopen_read
from repro_torch.core.writer import fopen_write

#: ``REPRO_SCDA_SHARDS``: default shard count for saves (0 = single file).
SHARDS_ENV = "REPRO_SCDA_SHARDS"

SHARDED_FORMAT = mf.SHARDED_FORMAT

#: ``<stem>-s<k>of<n>.scda`` — what a shard file is named.  The step
#: pattern the manager scans for (``step_NNNNNNNNNN.scda``) can never
#: match a shard name, so shard files are invisible to ``all_steps``.
_SHARD_RE = re.compile(r"^(?P<stem>.+)-s(?P<k>\d+)of(?P<n>\d+)\.scda$")


def shards_default() -> int:
    """Resolve the ``REPRO_SCDA_SHARDS`` knob (0 / unset = single file)."""
    try:
        return max(0, int(os.environ.get(SHARDS_ENV, "0")))
    except ValueError:
        return 0


def shard_file(path: str, k: int, n: int) -> str:
    """Path of shard ``k`` of ``n`` for the manifest at ``path``."""
    stem = path[:-len(".scda")] if path.endswith(".scda") else path
    width = max(2, len(str(n - 1)), len(str(n)))
    return f"{stem}-s{k:0{width}d}of{n:0{width}d}.scda"


def is_shard_name(name: str) -> Optional[Tuple[str, int, int]]:
    """``(manifest_name, k, n)`` if ``name`` looks like a shard file,
    else None — the retention sweep uses this to spot orphaned shards."""
    m = _SHARD_RE.match(name)
    if not m:
        return None
    return (m.group("stem") + ".scda", int(m.group("k")), int(m.group("n")))


def assign_shards(sizes: List[int], n: int) -> List[int]:
    """Deterministic greedy balance: walk leaves in manifest order,
    placing each on the least-loaded shard (ties → lowest index).

    Walking in manifest order (not sorted by size) keeps a leaf's shard
    stable under small tree changes, which is what lets sharded delta
    saves keep matching leaves against the same base shard.
    """
    loads = [0] * n
    out: List[int] = []
    for s in sizes:
        k = min(range(n), key=lambda i: (loads[i], i))
        out.append(k)
        loads[k] += max(1, int(s))  # zero-byte leaves still take a slot
    return out


# --------------------------------------------------------------------------
# Saving
# --------------------------------------------------------------------------

def _shard_delta_base(base: Optional[Tuple[Dict[str, Any], str]],
                      k: int) -> Optional[Tuple[Dict[str, Any], str]]:
    """The per-shard ``(doc, file)`` delta base derived from a set-level
    base: shard ``k`` pairs with the base's shard ``k`` (sharded base) or
    with the whole archive (single-file base).  Leaves that moved shards
    simply miss their name in the paired base doc and are stored fully —
    correctness never depends on the pairing, only the dedup hit rate.
    """
    from repro_torch.checkpoint import delta as _delta
    if base is None:
        return None
    bdoc, bname = base
    if bdoc.get("format") == SHARDED_FORMAT:
        sdocs = bdoc.get("shard_docs")
        if not sdocs or k >= len(sdocs):
            return None
        if not _delta.base_usable(sdocs[k]):
            return None
        return (sdocs[k], bdoc["shards"][k]["file"])
    if not _delta.base_usable(bdoc):
        return None
    return (bdoc, bname)


def save_sharded(path: str, tree, *, shards: int,
                 comm: Optional[Communicator] = None,
                 step: Optional[int] = None, compressed: bool = False,
                 chunk_bytes: Optional[int] = None,
                 aux_extra: Optional[Dict[str, Any]] = None,
                 write_window: Optional[int] = None,
                 record_hashes: bool = False,
                 delta_base: Optional[Tuple[Dict[str, Any], str]] = None,
                 parity: int = 0,
                 tmp_suffix: str = "",
                 vendor: Optional[bytes] = None) -> Dict[str, Any]:
    """Write ``tree`` as ``shards`` independent scda archives plus a
    manifest file at ``path``.

    Each shard goes through :func:`pytree_io._write_checkpoint` with its
    leaf subset in global manifest order — the identical code path a
    serial ``save`` of that subset takes, so per-shard serial
    equivalence is structural, not re-proven.  ``tmp_suffix`` is
    appended to every file actually written (the manager's atomic
    commit renames them; the manifest records the *final* names).
    ``vendor`` (default the port's) heads every file of the set: each
    shard, each parity file and the manifest.

    Returns the sharded manifest document augmented with ``shard_docs``
    (the in-memory per-shard manifest docs, for delta-base caching).
    """
    from repro_torch.checkpoint import pytree_io as pio
    comm = comm or SerialComm()
    vendor = vendor or pio.DEFAULT_VENDOR
    n = max(1, int(shards))
    if chunk_bytes is None:
        chunk_bytes = pio.DEFAULT_CHUNK_BYTES
    leaves, arrays, aux = pio._split_leaves(tree, compressed, chunk_bytes,
                                            aux_extra)

    placement = assign_shards([l["nbytes"] for l in leaves], n)
    _trace.event("shard_placement", "ckpt", shards=n,
                 leaves=len(leaves), parity=parity)
    shard_recs: List[Dict[str, Any]] = []
    shard_docs: List[Dict[str, Any]] = []
    placed: List[Dict[str, Any]] = []
    for k in range(n):
        idxs = [i for i, p in enumerate(placement) if p == k]
        for j, i in enumerate(idxs):
            placed.append({"name": leaves[i]["name"], "shard": k,
                           "index": j, "nbytes": leaves[i]["nbytes"],
                           "_order": i})
        sfile = shard_file(path, k, n)
        sdoc = pio._write_checkpoint(
            sfile + tmp_suffix, comm=comm, step=step,
            leaves=[leaves[i] for i in idxs],
            arrays=[arrays[i] for i in idxs], aux={},
            compressed=compressed, chunk_bytes=chunk_bytes,
            write_window=write_window, vendor=vendor,
            record_hashes=record_hashes,
            delta_base=_shard_delta_base(delta_base, k))
        shard_docs.append(sdoc)
        shard_recs.append({
            "file": os.path.basename(sfile),
            "id": mf.content_id(sdoc),
            "bytes": int(os.path.getsize(sfile + tmp_suffix)),
            "leaves": len(idxs),
        })
    placed.sort(key=lambda e: e["_order"])
    for e in placed:
        del e["_order"]
    doc = {
        "format": mf.SHARDED_FORMAT,
        "version": mf.SHARDED_VERSION,
        "step": step,
        "aux": aux,
        "shards": shard_recs,
        "leaves": placed,
    }
    if parity > 0 and comm.rank == 0:
        from repro_torch.checkpoint import redundancy as _red
        doc["parity"] = _red.write_parity_files(
            path, shard_recs, parity, step=step, tmp_suffix=tmp_suffix,
            sync=True, vendor=vendor)
    if parity > 0 and comm.size > 1:
        doc["parity"] = comm.bcast(doc.get("parity"), 0)
    # The manifest file: valid scda, tiny, written last (commit point
    # when tmp_suffix is empty — a crash mid-save leaves shards without
    # a manifest, which the retention sweep collects as orphans).
    with fopen_write(comm, path + tmp_suffix,
                     user_string=mf.SHARDS_FILE_USER_STRING,
                     vendor=vendor, sync=True) as f:
        f.write_inline(mf.STATUS_USER_STRING, mf.status_inline(step),
                       root=0)
        f.write_block(
            mf.SHARDS_MANIFEST_USER_STRING,
            mf.build_sharded(doc) if comm.rank == 0 else None,
            E=None, root=0)
    out = dict(doc)
    out["shard_docs"] = shard_docs
    return out


def set_paths(path: str, shards: int, tmp_suffix: str = "",
              parity: int = 0) -> List[str]:
    """Every file a ``save_sharded(path, shards=N, parity=m,
    tmp_suffix=...)`` writes — shards, then parity, manifest last
    (commit order)."""
    from repro_torch.checkpoint import redundancy as _red
    n = max(1, int(shards))
    return [shard_file(path, k, n) + tmp_suffix for k in range(n)] \
        + _red.set_parity_paths(path, parity, tmp_suffix) \
        + [path + tmp_suffix]


def commit_sharded(path: str, doc: Dict[str, Any],
                   tmp_suffix: str) -> None:
    """Atomically rename a sharded tmp set into place: shards (and
    parity) first, manifest last — the manifest rename is the commit
    point, and until it lands no reader can resolve the half-renamed
    set."""
    n = len(doc["shards"])
    d = os.path.dirname(os.path.abspath(path))
    with _trace.span("commit", "ckpt", path=path, shards=n):
        for k in range(n):
            sfile = shard_file(path, k, n)
            replace_file(sfile + tmp_suffix, sfile)
        for rec in (doc.get("parity") or {}).get("files", []):
            pfile = os.path.join(d, rec["file"])
            replace_file(pfile + tmp_suffix, pfile)
        # Shard renames must be durable BEFORE the manifest rename: the
        # manifest is the commit point, so once it lands every shard
        # entry it names has to survive the same power cut.
        fsync_dir(d)
        replace_file(path + tmp_suffix, path)
        fsync_dir(d)


# --------------------------------------------------------------------------
# Opening / verifying a set
# --------------------------------------------------------------------------

def read_sharded_manifest(path: str,
                          comm: Optional[Communicator] = None) \
        -> Dict[str, Any]:
    """The sharded manifest document of ``path`` (no shard opens)."""
    with fopen_read(comm, path) as r:
        hdr = r.read_section_header()
        if hdr.type != "I" or hdr.user_string != mf.STATUS_USER_STRING:
            raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                            "not a sharded checkpoint: missing status "
                            "inline")
        step = mf.parse_status_inline(r.read_inline_data())
        hdr = r.read_section_header()
        if hdr.type != "B" \
                or hdr.user_string != mf.SHARDS_MANIFEST_USER_STRING:
            raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                            "not a sharded checkpoint: missing shards "
                            "manifest block")
        doc = mf.parse_sharded(r.read_block_data())
        if doc.get("step") is None:
            doc["step"] = step
        return doc


def _shard_rec(doc: Dict[str, Any], k: int) -> Dict[str, Any]:
    shards = doc.get("shards", [])
    if not 0 <= k < len(shards):
        raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                        f"leaf placement names shard {k}, manifest lists "
                        f"{len(shards)}")
    return shards[k]


def _open_shard(spath: str, srec: Dict[str, Any],
                comm: Optional[Communicator]):
    """Collectively open one shard, naming the absent file on failure."""
    try:
        return fopen_read(comm, spath)
    except ScdaError as e:
        if e.code == ScdaErrorCode.FS_OPEN \
                and not os.path.exists(spath):
            raise ScdaError(
                ScdaErrorCode.FS_OPEN,
                f"missing shard file {srec.get('file')!r}: {e}") from e
        raise
    except FileNotFoundError as e:
        raise ScdaError(
            ScdaErrorCode.FS_OPEN,
            f"missing shard file {srec.get('file')!r}: {e}") from e


def _check_shard_doc(srec: Dict[str, Any], sdoc: Dict[str, Any]) -> None:
    got = mf.content_id(sdoc)
    if got != srec.get("id"):
        raise ScdaError(
            ScdaErrorCode.CORRUPT_CHECKSUM,
            f"shard {srec.get('file')!r}: content id {got} != recorded "
            f"{srec.get('id')} — the shard was rewritten since the set "
            f"was saved")


def load_set(path: str, *, comm: Optional[Communicator] = None,
             verify: bool = True) -> Dict[str, Any]:
    """The sharded manifest doc with every shard's own manifest attached
    as ``shard_docs`` (content-id-verified unless ``verify=False``)."""
    from repro_torch.checkpoint import pytree_io as pio
    doc = read_sharded_manifest(path, comm)
    base = os.path.dirname(path)
    sdocs: List[Dict[str, Any]] = []
    for srec in doc.get("shards", []):
        spath = os.path.join(base, srec.get("file", ""))
        with _open_shard(spath, srec, comm) as r:
            sdoc = pio._read_header_sections(r)
        if verify:
            _check_shard_doc(srec, sdoc)
        sdocs.append(sdoc)
    doc["shard_docs"] = sdocs
    return doc


def verify_set(path: str) -> List[str]:
    """Manifest-vs-disk consistency of a sharded set; returns problem
    strings (empty = consistent).  Checks existence (naming the absent
    file), recorded byte size, and the pinned content id of every shard —
    the cheap metadata pass ``scdatool verify``/``fsck`` runs before any
    payload validation."""
    from repro_torch.checkpoint import pytree_io as pio
    problems: List[str] = []
    try:
        doc = read_sharded_manifest(path)
    except (ScdaError, OSError, ValueError) as e:
        return [f"manifest unreadable: {e}"]
    base = os.path.dirname(os.path.abspath(path))
    for k, srec in enumerate(doc.get("shards", [])):
        name = srec.get("file", "")
        spath = os.path.join(base, name)
        if not os.path.exists(spath):
            problems.append(f"shard #{k} {name!r}: missing shard file")
            continue
        size = os.path.getsize(spath)
        if size != srec.get("bytes"):
            problems.append(
                f"shard #{k} {name!r}: {size} bytes on disk, manifest "
                f"recorded {srec.get('bytes')}")
        try:
            with fopen_read(None, spath) as r:
                sdoc = pio._read_header_sections(r)
            _check_shard_doc(srec, sdoc)
        except (ScdaError, OSError, ValueError) as e:
            problems.append(f"shard #{k} {name!r}: {e}")
    if doc.get("parity"):
        from repro_torch.checkpoint import redundancy as _red
        for j, rec in enumerate(doc["parity"].get("files", [])):
            name = rec.get("file", "")
            for p in _red.verify_parity_file(
                    os.path.join(base, name), rec):
                problems.append(f"parity #{j} {name!r}: {p}")
    return problems


def chain_depth(doc: Dict[str, Any]) -> int:
    """Delta-chain depth of a checkpoint doc, sharded or flat (the
    manager's chain-cap check; a sharded doc needs ``shard_docs``)."""
    if doc.get("format") == SHARDED_FORMAT:
        return max((int((sd.get("delta") or {}).get("depth", 0))
                    for sd in doc.get("shard_docs", [])), default=0)
    return int((doc.get("delta") or {}).get("depth", 0))


def base_usable_any(doc: Dict[str, Any]) -> bool:
    """Can ``doc`` (sharded or flat) serve as the next delta's base?"""
    from repro_torch.checkpoint import delta as _delta
    if doc.get("format") == SHARDED_FORMAT:
        return any(_delta.base_usable(sd)
                   for sd in doc.get("shard_docs", []))
    return _delta.base_usable(doc)


# --------------------------------------------------------------------------
# Restoring
# --------------------------------------------------------------------------

def _restore_from_open_shard(r, srec: Dict[str, Any], wanted,
                             pf: int, device, adopt: bool = True) \
        -> Dict[str, Any]:
    """Restore ``wanted`` — ``(name, shard_leaf_index, target)`` tuples —
    from one OPEN shard reader, content-id-verified against the
    manifest.  ``adopt=False`` skips sidecar adoption (degraded mode:
    the on-disk sidecar describes whatever replaced the lost file, not
    the reconstructed bytes)."""
    from repro_torch.checkpoint import pytree_io as pio
    sdoc = pio._read_header_sections(r)
    _check_shard_doc(srec, sdoc)
    tuples = []
    for name, j, target in wanted:
        if j >= len(sdoc["leaves"]) \
                or sdoc["leaves"][j]["name"] != name:
            raise ScdaError(
                ScdaErrorCode.CORRUPT_ENCODING,
                f"shard {srec.get('file')!r}: manifest places leaf "
                f"{name!r} at index {j}, the shard disagrees")
        tuples.append((name, j, sdoc["leaves"][j], target))
    if adopt:
        pio._adopt_sidecar(r)
    if sdoc.get("delta"):
        from repro_torch.checkpoint import delta as _delta
        return _delta.restore_chained(r, sdoc, tuples, pf, device=device)
    if pf > 0:
        return pio._restore_pipelined(r, tuples, pf, device)
    values: Dict[str, Any] = {}
    for name, j, spec_, target in tuples:
        hdr = r.open_section(mf.leaf_user_string(j))
        pio._check_leaf_header(hdr, spec_)
        values[name] = pio._read_leaf_to_target(r, spec_, target, device)
    return values


def _degraded_eligible(e: ScdaError) -> bool:
    """Failures the erasure code can route around: a missing file, or
    corruption of the shard's bytes (rewritten file, torn tail, chunk
    CRC / decode failure).  Usage errors (group 3) never degrade."""
    return e.code == ScdaErrorCode.FS_OPEN or e.group == 1


def _restore_from_shard(spath: str, srec: Dict[str, Any], wanted,
                        comm: Optional[Communicator], pf: int, device,
                        set_ctx: Optional[Tuple[str, Dict[str, Any]]]
                        = None, verify: bool = False) -> Dict[str, Any]:
    """Restore ``wanted`` from one shard archive; when the shard is
    lost or corrupt and the set carries parity (``set_ctx`` =
    ``(manifest_path, doc)``), fall back transparently to a degraded
    read over the surviving shards + parity.  ``verify`` CRC-checks the
    shard against its checksummed sidecar first (skipped on the
    degraded path: the on-disk sidecar describes the lost file, while
    the reconstructed bytes are re-proven by the content-id pin)."""
    try:
        if verify:
            from repro_torch.checkpoint import pytree_io as pio
            pio._verify_archive(spath)
        with _open_shard(spath, srec, comm) as r:
            return _restore_from_open_shard(r, srec, wanted, pf, device)
    except ScdaError as e:
        if set_ctx is None or not _degraded_eligible(e) \
                or not set_ctx[1].get("parity"):
            raise
        from repro_torch.checkpoint import redundancy as _red
        mpath, doc = set_ctx
        r = _red.degraded_reader(mpath, doc, srec["file"], comm=comm)
        try:
            # pf=0: the serial oracle path — reconstruction already
            # batches survivor reads per range, background prefetch on
            # top would only reorder them.
            return _restore_from_open_shard(r, srec, wanted, 0, device,
                                            adopt=False)
        finally:
            r.close()


def _by_shard(entries) -> Dict[int, List[Tuple[str, int, Any]]]:
    """Group ``(placement_entry, target)`` pairs by shard, each group in
    within-shard index order — one deterministic collective open per
    shard, every rank visiting the same shards in the same order."""
    groups: Dict[int, List[Tuple[str, int, Any]]] = {}
    for entry, target in entries:
        groups.setdefault(int(entry["shard"]), []).append(
            (entry["name"], int(entry["index"]), target))
    for g in groups.values():
        g.sort(key=lambda w: w[1])
    return groups


def restore_sharded(path: str, doc: Dict[str, Any], like=None, *,
                    device=None, comm: Optional[Communicator] = None,
                    prefetch_bytes: Optional[int] = None,
                    verify: bool = False):
    """Restore a sharded checkpoint (the ``pytree_io.restore``
    delegation target).  Semantics mirror the flat restore exactly —
    ``like=None`` rebuilds a nested dict, a ``like`` tree restores lazily
    into its structure, each leaf on ``device`` or its ``like`` leaf's —
    with shards opened in a deterministic order."""
    from repro_torch.checkpoint import pytree_io as pio
    comm = comm or SerialComm()
    pf = pio._effective_prefetch(prefetch_bytes)
    step = doc.get("step")
    aux = doc.get("aux", {})
    base = os.path.dirname(path)
    placed = {e["name"]: e for e in doc.get("leaves", [])}

    if like is None:
        groups = _by_shard([(e, None) for e in doc.get("leaves", [])])
        out: Dict[str, Any] = {}
        for k in sorted(groups):
            srec = _shard_rec(doc, k)
            out.update(_restore_from_shard(
                os.path.join(base, srec.get("file", "")), srec,
                groups[k], comm, pf, device, set_ctx=(path, doc),
                verify=verify))
        for name, value in aux.items():
            out[name] = value
        return pio._unflatten_names(out), step

    named, rebuild = pio.flatten_named(like)
    targets = {n: v for n, v in named}
    missing = [n for n in targets if n not in placed and n not in aux]
    if missing:
        raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                        f"leaves missing from checkpoint: {missing[:5]}"
                        f"{'…' if len(missing) > 5 else ''}")
    groups = _by_shard([(placed[n], targets[n])
                        for n in targets if n in placed])
    values: Dict[str, Any] = {}
    for k in sorted(groups):
        srec = _shard_rec(doc, k)
        values.update(_restore_from_shard(
            os.path.join(base, srec.get("file", "")), srec,
            groups[k], comm, pf, device, set_ctx=(path, doc),
            verify=verify))
    for name in targets:
        if name in aux:
            values[name] = aux[name]
    return rebuild([values[n] for n, _ in named]), step


def restore_leaf_sharded(path: str, doc: Dict[str, Any], name: str,
                         like=None, *, device=None,
                         comm: Optional[Communicator] = None,
                         prefetch_bytes: Optional[int] = None,
                         verify: bool = False):
    """Load ONE leaf of a sharded checkpoint: resolve its shard from the
    manifest, open that shard only (the lazy-restore workload, now also
    lazy across *files*)."""
    from repro_torch.checkpoint import pytree_io as pio
    comm = comm or SerialComm()
    pf = pio._effective_prefetch(prefetch_bytes)
    placed = {e["name"]: e for e in doc.get("leaves", [])}
    if name in placed:
        entry = placed[name]
        srec = _shard_rec(doc, int(entry["shard"]))
        return _restore_from_shard(
            os.path.join(os.path.dirname(path), srec.get("file", "")),
            srec, [(name, int(entry["index"]), like)], comm, pf, device,
            set_ctx=(path, doc), verify=verify)[name]
    if name in doc.get("aux", {}):
        return doc["aux"][name]
    raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                    f"leaf {name!r} not in checkpoint")


def restore_flat(path: str, doc: Optional[Dict[str, Any]] = None, *,
                 prefetch_bytes: Optional[int] = None) \
        -> Tuple[Dict[str, Any], Optional[int]]:
    """Every array leaf of a sharded set as a flat ``{name: tensor}``
    dict (on the host) in global manifest order — the tooling entry (``squash``,
    ``diff`` payload fallbacks) that wants values without tree
    structure."""
    from repro_torch.checkpoint import pytree_io as pio
    if doc is None:
        doc = read_sharded_manifest(path)
    pf = pio._effective_prefetch(prefetch_bytes)
    base = os.path.dirname(path)
    groups = _by_shard([(e, None) for e in doc.get("leaves", [])])
    values: Dict[str, Any] = {}
    for k in sorted(groups):
        srec = _shard_rec(doc, k)
        values.update(_restore_from_shard(
            os.path.join(base, srec.get("file", "")), srec,
            groups[k], None, pf, None, set_ctx=(path, doc)))
    return values, doc.get("step")


def combined_document(path: str, *,
                      doc: Optional[Dict[str, Any]] = None) \
        -> Dict[str, Any]:
    """A flat-checkpoint-shaped view of a sharded set: full leaf specs
    (with digest tables, when recorded) assembled in global manifest
    order — what chain-aware tooling (``diff``) compares against."""
    from repro_torch.checkpoint import pytree_io as pio  # noqa: F401
    if doc is None or "shard_docs" not in doc:
        doc = load_set(path)
    leaves: List[Dict[str, Any]] = []
    for entry in doc.get("leaves", []):
        sdoc = doc["shard_docs"][int(entry["shard"])]
        leaves.append(sdoc["leaves"][int(entry["index"])])
    return {"format": "repro-scda-checkpoint",
            "step": doc.get("step"), "aux": doc.get("aux", {}),
            "leaves": leaves, "sharded": True}


def summarize(path: str) -> Dict[str, Any]:
    """Cheap ls-able summary of a sharded set (manifest reads only)."""
    doc = read_sharded_manifest(path)
    base = os.path.dirname(os.path.abspath(path))
    shards = []
    for srec in doc.get("shards", []):
        name = srec.get("file", "")
        shards.append({
            "file": name,
            "id": srec.get("id"),
            "bytes": srec.get("bytes"),
            "leaves": srec.get("leaves"),
            "present": os.path.exists(os.path.join(base, name)),
        })
    out = {"format": mf.SHARDED_FORMAT,
           "version": doc.get("version", mf.SHARDED_VERSION),
           "step": doc.get("step"), "shards": shards,
           "leaves": len(doc.get("leaves", [])),
           "aux": len(doc.get("aux", {}))}
    prec = doc.get("parity")
    if prec:
        out["parity"] = [{
            "file": rec.get("file"),
            "id": rec.get("id"),
            "bytes": rec.get("bytes"),
            "present": os.path.exists(
                os.path.join(base, rec.get("file", ""))),
        } for rec in prec.get("files", [])]
        out["parity_code"] = prec.get("code")
    return out
