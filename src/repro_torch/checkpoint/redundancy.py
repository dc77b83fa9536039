"""Erasure-coded shard sets — parity shards, reconstruction, rebuild.
The port of the JAX package's ``repro/checkpoint/redundancy.py``: parity
written here over a set written with the reference's vendor string is
the reference's, byte for byte, and each package reconstructs and
rebuilds the other's sets.

A sharded checkpoint (``repro_torch.checkpoint.sharding``) is N independent
scda archives pinned by a manifest; lose any one shard and the whole
set used to be gone.  This module layers an m-erasure code over the set
without touching the format: each parity shard is itself a byte-valid
scda file computed over the *raw file byte streams* of the N data
shards, zero-padded to the longest shard:

    F  header (user string "repro ckpt-parity")
    I  "scda-ckpt status"      — same human-readable step line
    B  "scda-parity meta"      — JSON: code geometry, per-shard sizes,
                                 payload CRC32
    A  "scda-parity payload"   — the parity byte stream (raw; parity
                                 bytes are high-entropy, §3 encoding
                                 would only burn CPU)

Codes: ``m=1`` is plain XOR; ``m=2`` is a 2-row GF(2^8) Reed–Solomon
Vandermonde code (generator α=2, polynomial 0x11d) — parity row j holds
``P_j = Σ_i α^(i·j) · D_i``, vectorized with numpy through per-constant
256-entry multiplication tables.  Coding over whole file streams (not
logical chunks) is what makes ``repair --rebuild`` byte-identical and
range reconstruction trivial: byte b of a lost shard depends only on
byte b of every survivor.

Degraded reads never trust reconstruction blindly: a reconstructed
shard still flows through the ordinary content-id pinning and chunk CRC
checks downstream, so rotten parity or a rotten survivor fails loudly
instead of assembling silently wrong tensors.

Knobs: ``CheckpointManager(parity=m)`` / ``save(..., parity=m)`` or
``REPRO_SCDA_PARITY=m`` (0 = no parity; parity without sharding is a
no-op).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import manifest as mf
from repro_torch.core import trace as _trace
from repro_torch.core.errors import ScdaError, ScdaErrorCode
from repro_torch.core.io_backend import (DEFAULT_READAHEAD, FileBackend,
                                         fsync_dir, replace_file)
from repro_torch.core.reader import ScdaReader, fopen_read
from repro_torch.core.writer import fopen_write

#: ``REPRO_SCDA_PARITY``: default parity shard count for sharded saves.
PARITY_ENV = "REPRO_SCDA_PARITY"

PARITY_FILE_USER_STRING = b"repro ckpt-parity"
PARITY_META_USER_STRING = b"scda-parity meta"
PARITY_PAYLOAD_USER_STRING = b"scda-parity payload"
PARITY_FORMAT = "repro-scda-parity"
PARITY_VERSION = 1

#: Max parity shards (XOR at 1, 2-row RS at 2).
MAX_PARITY = 2

#: ``<stem>-p<j>of<m>.scda`` — what a parity file is named.  Cannot
#: collide with data shards (``-s<k>of<n>``) or the step pattern.
_PARITY_RE = re.compile(r"^(?P<stem>.+)-p(?P<j>\d+)of(?P<m>\d+)\.scda$")

_STREAM_CHUNK = 4 << 20
#: A rebuild reconstructs this much a read (many windows, on many cores).
_REBUILD_BLOCK = 16 * _STREAM_CHUNK


def parity_default() -> int:
    """Resolve the ``REPRO_SCDA_PARITY`` knob (0 / unset = no parity)."""
    try:
        return max(0, int(os.environ.get(PARITY_ENV, "0")))
    except ValueError:
        return 0


def parity_file(path: str, j: int, m: int) -> str:
    """Path of parity shard ``j`` of ``m`` for the manifest at ``path``."""
    stem = path[:-len(".scda")] if path.endswith(".scda") else path
    width = max(2, len(str(m - 1)), len(str(m)))
    return f"{stem}-p{j:0{width}d}of{m:0{width}d}.scda"


def is_parity_name(name: str) -> Optional[Tuple[str, int, int]]:
    """``(manifest_name, j, m)`` if ``name`` looks like a parity file,
    else None — the retention sweep uses this to spot orphaned parity."""
    g = _PARITY_RE.match(name)
    if not g:
        return None
    return (g.group("stem") + ".scda", int(g.group("j")), int(g.group("m")))


def check_geometry(shards: int, parity: int) -> None:
    """Validate a requested code geometry before any bytes move."""
    if parity < 0 or parity > MAX_PARITY:
        raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                        f"parity={parity}: supported 0..{MAX_PARITY} "
                        f"(XOR at 1, GF(2^8) RS at 2)")
    if parity >= 2 and shards > 255:
        raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                        f"parity=2 needs distinct GF(2^8) code points: "
                        f"shards={shards} > 255")


# --------------------------------------------------------------------------
# GF(2^8) arithmetic — generator α=2, polynomial 0x11d, table-driven
# --------------------------------------------------------------------------

_GF_EXP: Optional[np.ndarray] = None
_GF_LOG: Optional[np.ndarray] = None
_MUL_TABLES: Dict[int, np.ndarray] = {}


def _gf_tables() -> Tuple[np.ndarray, np.ndarray]:
    global _GF_EXP, _GF_LOG
    if _GF_EXP is None:
        exp = np.zeros(512, dtype=np.uint8)
        log = np.zeros(256, dtype=np.int32)
        x = 1
        for i in range(255):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & 0x100:
                x ^= 0x11D
        exp[255:510] = exp[0:255]
        _GF_EXP, _GF_LOG = exp, log
    return _GF_EXP, _GF_LOG


def gf_pow_alpha(i: int) -> int:
    """α^i in GF(2^8)."""
    exp, _ = _gf_tables()
    return int(exp[i % 255])


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    exp, log = _gf_tables()
    return int(exp[int(log[a]) + int(log[b])])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    exp, log = _gf_tables()
    return int(exp[255 - int(log[a])])


def _mul_table(c: int) -> np.ndarray:
    """256-entry lookup table for ``c · v`` — ``table[arr]`` vectorizes
    constant multiplication over a whole byte stream."""
    t = _MUL_TABLES.get(c)
    if t is None:
        v = np.arange(256, dtype=np.uint8)
        if c == 0:
            t = np.zeros(256, dtype=np.uint8)
        elif c == 1:
            t = v.copy()
        else:
            exp, log = _gf_tables()
            t = np.zeros(256, dtype=np.uint8)
            t[1:] = exp[int(log[c]) + log[1:]]
        _MUL_TABLES[c] = t
    return t


def _mul_into(acc: np.ndarray, c: int, data) -> None:
    """acc ^= c · data, vectorized (``data``: uint8 array or buffer)."""
    if not isinstance(data, np.ndarray):
        data = np.frombuffer(data, dtype=np.uint8)
    if c == 0 or data.size == 0:
        return
    if c == 1:
        acc[:len(data)] ^= data
    else:
        acc[:len(data)] ^= _mul_table(c)[data]


def _coeff(i: int, j: int) -> int:
    """Code coefficient of data shard ``i`` in parity row ``j``."""
    return 1 if j == 0 else gf_pow_alpha(i * j)


# --------------------------------------------------------------------------
# Parity emission (save path)
# --------------------------------------------------------------------------

def _canonical_meta(meta: Dict[str, Any]) -> bytes:
    return json.dumps(meta, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def parity_id(meta: Dict[str, Any]) -> str:
    """Deterministic 128-bit id of a parity shard — hashed over the
    canonical meta JSON (which pins the payload via its CRC32), so a
    cheap meta-block read verifies a parity file against the manifest."""
    return hashlib.blake2b(_canonical_meta(meta),
                           digest_size=16).hexdigest()


def _read_backend(backend, offset: int, n: int, what: str,
                  context: str) -> np.ndarray:
    """``n`` bytes of an open file at ``offset`` through positioned reads
    (no shared read cache, so several threads may read at once)."""
    buf = np.empty(n, dtype=np.uint8)
    got = backend.preadv(offset, [memoryview(buf)])
    if got < n:
        raise ScdaError(
            ScdaErrorCode.CORRUPT_TRUNCATED,
            f"{what}: EOF at {offset + got}, wanted {offset + n}{context}",
            offset=offset + got)
    return buf


def write_parity_files(path: str, shard_recs: List[Dict[str, Any]],
                       parity: int, *, step: Optional[int] = None,
                       tmp_suffix: str = "", in_suffix: Optional[str] = None,
                       sync: bool = True,
                       vendor: Optional[bytes] = None) -> Dict[str, Any]:
    """Compute and write ``parity`` parity shards over the (already
    written) data shard files of the set at ``path``; returns the
    manifest ``parity`` record.

    One pass over the shard files codes every row at once, in 4 MiB
    windows spread over the host's cores (:func:`manifest.host_map`:
    byte b of a row depends only on byte b of each shard, so the windows
    are independent and the bytes are the reference's row-by-row loop's);
    peak memory the coded rows.  ``vendor`` (default the port's) heads
    each parity file.
    """
    from repro_torch.checkpoint.pytree_io import DEFAULT_VENDOR
    check_geometry(len(shard_recs), parity)
    if in_suffix is None:
        in_suffix = tmp_suffix  # a save reads the not-yet-renamed shards
    base = os.path.dirname(path)
    names = [r["file"] for r in shard_recs]
    sizes = [int(r["bytes"]) for r in shard_recs]
    length = max(sizes) if sizes else 0
    code = "xor" if parity == 1 else "rs8"
    files: List[Dict[str, Any]] = []
    _tc = _trace.collector()
    _t0 = _tc.now() if _tc is not None else 0
    backends: List[FileBackend] = []
    try:
        for n in names:
            backends.append(FileBackend(os.path.join(base, n) + in_suffix,
                                        "r", create=False))

        def window(off: int) -> List[np.ndarray]:
            cl = min(_STREAM_CHUNK, length - off)
            accs = [np.zeros(cl, dtype=np.uint8) for _ in range(parity)]
            for i, backend in enumerate(backends):
                want = max(0, min(sizes[i], off + cl) - off)
                data = _read_backend(backend, off, want, backend.path,
                                     " while computing parity")
                for j, acc in enumerate(accs):
                    _mul_into(acc, _coeff(i, j), data)
            return accs

        rows = list(zip(*mf.host_map(window,
                                     range(0, length, _STREAM_CHUNK))))
    finally:
        for backend in backends:
            backend.close()
    for j in range(parity):
        chunks = rows[j] if rows else ()
        crc = 0
        for c in chunks:
            crc = zlib.crc32(c, crc)
        meta = {"format": PARITY_FORMAT, "version": PARITY_VERSION,
                "code": code, "n": len(names), "m": parity, "j": j,
                "length": length, "sizes": sizes, "shards": names,
                "crc32": crc & 0xFFFFFFFF, "step": step}
        pid = parity_id(meta)
        ppath = parity_file(path, j, parity)
        with fopen_write(None, ppath + tmp_suffix,
                         user_string=PARITY_FILE_USER_STRING,
                         vendor=vendor or DEFAULT_VENDOR,
                         sync=sync) as f:
            f.write_inline(mf.STATUS_USER_STRING, mf.status_inline(step))
            f.write_block(PARITY_META_USER_STRING, _canonical_meta(meta))
            windows, pos = [], 0
            for c in chunks:
                windows.append((pos, c))
                pos += len(c)
            f.write_array_windows(PARITY_PAYLOAD_USER_STRING, windows,
                                  length, 1)
        files.append({"file": os.path.basename(ppath), "id": pid,
                      "bytes": int(os.path.getsize(ppath + tmp_suffix))})
    if _tc is not None:
        _tc.end("parity_encode", "ckpt", _t0,
                {"path": path, "code": code, "n": len(shard_recs),
                 "m": parity, "bytes": length * parity})
    return {"code": code, "m": parity, "length": length, "files": files}


def set_parity_paths(path: str, parity: int,
                     tmp_suffix: str = "") -> List[str]:
    """Every parity file a ``parity=m`` save writes for the set at
    ``path`` (tmp-sweep / commit bookkeeping)."""
    return [parity_file(path, j, parity) + tmp_suffix
            for j in range(max(0, int(parity)))]


# --------------------------------------------------------------------------
# Reading parity files back
# --------------------------------------------------------------------------

def read_parity_meta(path: str) -> Dict[str, Any]:
    """The meta document of a parity shard (no payload reads)."""
    with fopen_read(None, path) as r:
        meta, _, _ = _parity_sections(r)
    return meta


def _parity_sections(r: ScdaReader) -> Tuple[Dict[str, Any], int, int]:
    """(meta, payload_data_start, payload_bytes) of an open parity file."""
    if r.user_string != PARITY_FILE_USER_STRING:
        raise ScdaError(
            ScdaErrorCode.CORRUPT_ENCODING,
            f"{r.path}: not a parity shard (file user string "
            f"{r.user_string!r})")
    r.open_section(PARITY_META_USER_STRING)
    raw = r.read_block_data()
    try:
        meta = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                        f"{r.path}: parity meta is not JSON: {e}") from e
    if meta.get("format") != PARITY_FORMAT \
            or meta.get("version") != PARITY_VERSION:
        raise ScdaError(
            ScdaErrorCode.CORRUPT_ENCODING,
            f"{r.path}: unknown parity format "
            f"{meta.get('format')!r} v{meta.get('version')!r}")
    idx = r.index()
    i = idx.find(PARITY_PAYLOAD_USER_STRING)
    if i < 0:
        raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                        f"{r.path}: no parity payload section")
    e = idx.entries[i]
    if e.kind != "A" or e.E != 1 or e.N != meta.get("length"):
        raise ScdaError(
            ScdaErrorCode.CORRUPT_ENCODING,
            f"{r.path}: parity payload is {e.kind} N={e.N} E={e.E}, "
            f"meta says raw A N={meta.get('length')} E=1")
    return meta, e.data_start, e.N * e.E


def verify_parity_file(path: str, rec: Dict[str, Any],
                       deep: bool = False) -> List[str]:
    """Problems of one parity file against its manifest record.  Cheap
    pass: structure + meta id.  ``deep`` additionally CRCs the payload."""
    problems: List[str] = []
    try:
        size = os.path.getsize(path)
    except OSError:
        return ["missing parity file"]
    if size != rec.get("bytes"):
        problems.append(f"{size} bytes on disk, manifest recorded "
                        f"{rec.get('bytes')}")
    try:
        with fopen_read(None, path) as r:
            meta, data_start, nbytes = _parity_sections(r)
            got = parity_id(meta)
            if got != rec.get("id"):
                problems.append(
                    f"parity id {got} != recorded {rec.get('id')} — the "
                    f"parity file was rewritten since the set was saved")
            elif deep:
                crc = 0
                for off in range(0, nbytes, _STREAM_CHUNK):
                    n = min(_STREAM_CHUNK, nbytes - off)
                    crc = zlib.crc32(
                        r._backend.pread(data_start + off, n), crc)
                if crc & 0xFFFFFFFF != meta.get("crc32"):
                    problems.append(
                        f"payload CRC32 {crc & 0xFFFFFFFF:#010x} != "
                        f"recorded {meta.get('crc32'):#010x}")
    except (ScdaError, OSError, ValueError) as e:
        problems.append(str(e))
    return problems


# --------------------------------------------------------------------------
# Reconstruction
# --------------------------------------------------------------------------

def warn_degraded(set_name: str, lost: List[str], via: List[str]) -> None:
    """The loud one-line degraded-read warning.

    Routed through :func:`repro_torch.core.trace.warn` — logging-backed (so
    tests and applications can capture or silence it) and rate-limited
    per (set, lost-file) key so a restore that reconstructs a lost shard
    leaf-by-leaf warns once, not once per read."""
    _trace.warn(
        f"DEGRADED READ of {set_name!r}: reconstructing "
        f"{', '.join(sorted(lost))} from surviving shards + "
        f"{', '.join(via)}",
        key=("degraded", set_name, tuple(sorted(lost))))
    _trace.event("degraded_read", "ckpt", set=set_name,
                 lost=",".join(sorted(lost)), via=",".join(via))


class SetReconstructor:
    """Byte-range reconstruction of lost data shards of one set.

    Classifies every data and parity file of the set as usable or lost
    (missing, wrong size, or — for parity — a meta id that no longer
    matches the manifest), refuses loudly when the erasure budget is
    exceeded, and serves ``read(name, offset, n)`` for any lost data
    shard by solving the (≤2)-erasure linear system over exactly the
    requested byte range of every survivor.
    """

    def __init__(self, path: str, doc: Dict[str, Any],
                 lost: Tuple[str, ...] = ()) -> None:
        self.path = path
        self.dir = os.path.dirname(os.path.abspath(path))
        prec = doc.get("parity")
        if not prec:
            raise ScdaError(
                ScdaErrorCode.FS_OPEN,
                f"{os.path.basename(path)}: set has no parity shards — "
                f"lost shards are unrecoverable")
        self.shards = doc.get("shards", [])
        self.names = [s["file"] for s in self.shards]
        self.sizes = [int(s["bytes"]) for s in self.shards]
        self.length = int(prec.get("length", 0))
        self.lost: set = set(lost)
        self._data: Dict[int, FileBackend] = {}
        for i, srec in enumerate(self.shards):
            name = srec["file"]
            if name in self.lost:
                continue
            spath = os.path.join(self.dir, name)
            try:
                if os.path.getsize(spath) != self.sizes[i]:
                    self.lost.add(name)
            except OSError:
                self.lost.add(name)
        unknown = self.lost - set(self.names)
        if unknown:
            raise ScdaError(
                ScdaErrorCode.ARG_SEQUENCE,
                f"not data shards of this set: {sorted(unknown)}")
        # Usable parity rows, cheap-verified against the manifest record.
        self.parity_rows: List[Tuple[int, ScdaReader, int]] = []
        self.lost_parity: List[str] = []
        for j, rec in enumerate(prec.get("files", [])):
            ppath = os.path.join(self.dir, rec.get("file", ""))
            try:
                r = fopen_read(None, ppath)
            except (ScdaError, OSError):
                self.lost_parity.append(rec.get("file", ""))
                continue
            try:
                meta, data_start, _ = _parity_sections(r)
                if parity_id(meta) != rec.get("id") \
                        or meta.get("j") != j \
                        or meta.get("sizes") != self.sizes \
                        or meta.get("length") != self.length:
                    raise ScdaError(ScdaErrorCode.CORRUPT_CHECKSUM,
                                    "parity meta mismatch")
            except (ScdaError, OSError, ValueError):
                r.close()
                self.lost_parity.append(rec.get("file", ""))
                continue
            self.parity_rows.append((j, r, data_start))
        n_lost = len(self.lost)
        if n_lost > len(self.parity_rows):
            self.close()
            raise ScdaError(
                ScdaErrorCode.CORRUPT_CHECKSUM,
                f"{os.path.basename(path)}: {n_lost} data shard(s) lost "
                f"({', '.join(sorted(self.lost))}) but only "
                f"{len(self.parity_rows)} usable parity shard(s) — "
                f"unrecoverable")
        self.via = [f"parity row {j}" for j, _, _ in
                    self.parity_rows[:max(1, n_lost)]]

    def shard_size(self, name: str) -> int:
        return self.sizes[self.names.index(name)]

    def _data_backend(self, i: int) -> FileBackend:
        b = self._data.get(i)
        if b is None:
            b = FileBackend(os.path.join(self.dir, self.names[i]),
                            "r", create=False)
            self._data[i] = b
        return b

    def read(self, name: str, offset: int, n: int) -> bytes:
        """Bytes ``[offset, offset+n)`` of lost data shard ``name``
        (short only past the shard's recorded EOF).  The range is solved
        in 4 MiB windows spread over the host's cores (byte b depends
        only on byte b of the survivors and the parity)."""
        x = self.names.index(name)
        n = max(0, min(n, self.sizes[x] - offset))
        if n <= 0:
            return b""
        lost_idx = sorted(self.names.index(m) for m in self.lost)
        if x not in lost_idx:
            lost_idx = sorted(lost_idx + [x])
        rows = self.parity_rows[:len(lost_idx)]
        if len(rows) < len(lost_idx):
            raise ScdaError(
                ScdaErrorCode.CORRUPT_CHECKSUM,
                f"{name}: {len(lost_idx)} erasures, "
                f"{len(self.parity_rows)} usable parity rows")
        if len(lost_idx) == 1:
            # D_x = c⁻¹ · S_0
            solve = [gf_inv(_coeff(x, rows[0][0]))]
        else:
            # Two erasures x < y: Cramer over the 2×2 GF system.
            ex, ey = lost_idx
            (ja, _, _), (jb, _, _) = rows[0], rows[1]
            a, b = _coeff(ex, ja), _coeff(ey, ja)
            c, d = _coeff(ex, jb), _coeff(ey, jb)
            det = gf_mul(a, d) ^ gf_mul(b, c)
            if det == 0:
                raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                                f"singular code matrix for erasures "
                                f"{ex},{ey}")
            inv_det = gf_inv(det)
            solve = ([gf_mul(d, inv_det), gf_mul(b, inv_det)] if x == ex
                     else [gf_mul(c, inv_det), gf_mul(a, inv_det)])
        survivors = [(i, self._data_backend(i))
                     for i in range(len(self.names)) if i not in lost_idx]
        out = np.zeros(n, dtype=np.uint8)

        def window(w: int) -> None:
            lo = offset + w
            cl = min(_STREAM_CHUNK, n - w)
            # Syndromes: S_j = P_j  ^  Σ_{i surviving} c_ji · D_i
            data = []
            for i, backend in survivors:
                want = max(0, min(self.sizes[i], lo + cl) - lo)
                if want > 0:
                    data.append((i, _read_backend(
                        backend, lo, want,
                        f"{self.names[i]}", f" while reconstructing "
                        f"{name!r}")))
            for k, (j, r, data_start) in enumerate(rows):
                acc = _read_backend(r._backend, data_start + lo, cl,
                                    r.path, "")
                for i, d in data:
                    _mul_into(acc, _coeff(i, j), d)
                _mul_into(out[w:w + cl], solve[k], acc)

        mf.host_map(window, range(0, n, _STREAM_CHUNK))
        return out.tobytes()

    def close(self) -> None:
        for b in self._data.values():
            try:
                b.close()
            except ScdaError:
                pass
        self._data = {}
        for _, r, _ in getattr(self, "parity_rows", []):
            try:
                r.close()
            except ScdaError:
                pass
        self.parity_rows = []


class DegradedBackend(FileBackend):
    """A :class:`FileBackend` whose byte source is reconstruction.

    Every FileBackend read path funnels into ``_pread_upto`` /
    ``preadv``; both are overridden to pull bytes out of a
    :class:`SetReconstructor`, so the readahead cache, coalesced
    scatter reads and §3 decode all work unchanged.  ``fd`` stays -1:
    ``prefetch`` and ``advise`` already no-op on fd < 0, and ``close``
    skips the os.close.
    """

    def __init__(self, recon: SetReconstructor, name: str,
                 close_recon: bool = False) -> None:
        self.path = os.path.join(recon.dir, name)
        self.mode = "r"
        self._inj = None
        self.fd = -1
        self._recon = recon
        self._recon_name = name
        self._recon_owned = close_recon
        self._size = recon.shard_size(name)
        import threading
        self._readahead = DEFAULT_READAHEAD
        self._cache = b""
        self._cache_off = 0
        self._pf_lock = threading.Lock()
        self._pf = {}
        self._pf_pool = None
        self._wb_lock = threading.Lock()
        self._wb = []
        self._wb_pool = None
        self._wb_error = None
        self._wb_poison = None

    def _pread_upto(self, offset: int, n: int) -> bytes:
        return self._recon.read(self._recon_name, offset, n)

    def preadv(self, offset: int, bufs) -> int:
        got = 0
        for v in bufs:
            v = v if isinstance(v, memoryview) else memoryview(v)
            if not len(v):
                continue
            data = self._recon.read(self._recon_name, offset + got, len(v))
            v[:len(data)] = data
            got += len(data)
            if len(data) < len(v):
                break
        return got

    def size(self) -> int:
        return self._size

    def close(self, sync: bool = False) -> None:
        if self._recon_owned:
            self._recon.close()


def degraded_reader(path: str, doc: Dict[str, Any], name: str,
                    comm=None, quiet: bool = False) -> ScdaReader:
    """An :class:`ScdaReader` over the reconstructed bytes of lost data
    shard ``name`` of the set at ``path`` — the transparent degraded
    restore path.  Raises (FS_OPEN / CORRUPT_CHECKSUM) when the loss
    exceeds the parity budget."""
    recon = SetReconstructor(path, doc, lost=(name,))
    if not quiet:
        warn_degraded(os.path.basename(path), sorted(recon.lost),
                      recon.via)
    backend = DegradedBackend(recon, name, close_recon=True)
    try:
        return ScdaReader(comm, backend.path, backend=backend)
    except BaseException:
        backend.close()
        raise


def degraded_base_reader(base_dir: str, name: str,
                         comm=None) -> Optional[ScdaReader]:
    """Degraded open of a delta-chain base that happens to be a shard of
    a parity-protected set; None when ``name`` is not recoverable this
    way (caller re-raises its original error)."""
    from repro_torch.checkpoint import sharding as _sharding
    hit = _sharding.is_shard_name(name)
    if hit is None:
        return None
    mpath = os.path.join(base_dir, hit[0])
    try:
        doc = _sharding.read_sharded_manifest(mpath)
    except (ScdaError, OSError, ValueError):
        return None
    if not doc.get("parity") \
            or name not in [s.get("file") for s in doc.get("shards", [])]:
        return None
    try:
        return degraded_reader(mpath, doc, name, comm=comm)
    except (ScdaError, OSError):
        return None


# --------------------------------------------------------------------------
# Rebuild + set health (repair / fsck)
# --------------------------------------------------------------------------

def rebuild_shard(path: str, doc: Dict[str, Any], name: str, *,
                  dry_run: bool = False) -> int:
    """Re-materialize lost shard ``name`` of the set at ``path`` in
    place: reconstruct its full byte stream, verify the bytes parse and
    the content id matches the manifest pin, then atomically rename into
    place (dir-fsynced).  Returns the shard's byte size."""
    from repro_torch.checkpoint import pytree_io as pio
    from repro_torch.checkpoint import sharding as _sharding
    recs = {s["file"]: s for s in doc.get("shards", [])}
    if name in recs:
        recon = SetReconstructor(path, doc, lost=(name,))
        try:
            size = recon.shard_size(name)
            backend = DegradedBackend(recon, name)
            with ScdaReader(None, backend.path, backend=backend) as r:
                sdoc = pio._read_header_sections(r)
                _sharding._check_shard_doc(recs[name], sdoc)
            if dry_run:
                return size
            target = os.path.join(recon.dir, name)
            tmp = target + ".rebuild"
            with open(tmp, "wb") as out:
                for off in range(0, size, _REBUILD_BLOCK):
                    out.write(recon.read(
                        name, off, min(_REBUILD_BLOCK, size - off)))
                out.flush()
                os.fsync(out.fileno())
            replace_file(tmp, target)
            fsync_dir(recon.dir)
            return size
        finally:
            recon.close()
    # A lost *parity* shard recomputes from the (complete) data shards.
    prec = doc.get("parity") or {}
    for j, rec in enumerate(prec.get("files", [])):
        if rec.get("file") != name:
            continue
        missing_data = [s["file"] for s in doc.get("shards", [])
                        if not os.path.exists(
                            os.path.join(os.path.dirname(path),
                                         s["file"]))]
        if missing_data:
            raise ScdaError(
                ScdaErrorCode.FS_OPEN,
                f"cannot recompute parity {name!r}: data shard(s) "
                f"{missing_data} missing — rebuild those first")
        if dry_run:
            return int(rec.get("bytes", 0))
        # Every file of a set carries its writer's vendor string, so a
        # data shard's header names the one the lost parity file had.
        first = os.path.join(os.path.dirname(path),
                             doc["shards"][0]["file"])
        with fopen_read(None, first) as r0:
            vendor = r0.vendor
        out = write_parity_files(path, doc.get("shards", []),
                                 int(prec.get("m", 0)),
                                 step=doc.get("step"),
                                 tmp_suffix=".rebuild", in_suffix="",
                                 sync=True, vendor=vendor)
        d = os.path.dirname(os.path.abspath(path))
        for jj, frec in enumerate(out["files"]):
            src = os.path.join(d, frec["file"])
            if frec["file"] == name:
                if frec["id"] != rec.get("id"):
                    os.remove(src + ".rebuild")
                    raise ScdaError(
                        ScdaErrorCode.CORRUPT_CHECKSUM,
                        f"recomputed parity {name!r} id {frec['id']} != "
                        f"recorded {rec.get('id')} — a data shard was "
                        f"rewritten since the set was saved")
                replace_file(src + ".rebuild", src)
            else:
                os.remove(src + ".rebuild")
        fsync_dir(d)
        return int(rec.get("bytes", 0))
    raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                    f"{name!r} is not a shard of this set")


def set_health(path: str, doc: Optional[Dict[str, Any]] = None) \
        -> Tuple[str, List[str], List[str]]:
    """Erasure-code health of the set at ``path``:
    ``("clean" | "degraded-recoverable" | "unrecoverable",
    lost_data_names, lost_parity_names)``.

    Lost means missing or wrong-sized (data), or missing /
    id-mismatched (parity) — the same cheap classification the
    reconstructor applies before any payload reads.
    """
    from repro_torch.checkpoint import sharding as _sharding
    if doc is None:
        doc = _sharding.read_sharded_manifest(path)
    base = os.path.dirname(os.path.abspath(path))
    lost_data: List[str] = []
    for srec in doc.get("shards", []):
        name = srec.get("file", "")
        spath = os.path.join(base, name)
        try:
            if os.path.getsize(spath) != srec.get("bytes"):
                lost_data.append(name)
        except OSError:
            lost_data.append(name)
    prec = doc.get("parity") or {}
    lost_parity: List[str] = []
    for rec in prec.get("files", []):
        if verify_parity_file(os.path.join(base, rec.get("file", "")),
                              rec):
            lost_parity.append(rec.get("file", ""))
    if not lost_data and not lost_parity:
        return ("clean", [], [])
    usable = len(prec.get("files", [])) - len(lost_parity)
    if len(lost_data) <= usable:
        return ("degraded-recoverable", lost_data, lost_parity)
    return ("unrecoverable", lost_data, lost_parity)
