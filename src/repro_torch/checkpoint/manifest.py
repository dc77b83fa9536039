"""Checkpoint manifest — the self-description layer scda leaves to the user.

scda is deliberately oblivious to variables, dtypes, and endianness (paper
§1: "the definition of variables … may all be specified on top of scda").
This module *is* that layer for nested dicts of torch tensors: a JSON
document stored in a block section, naming every leaf (tree path), its
shape/dtype/byte order, and how it is laid out in subsequent array
sections.  Dtype names are numpy's and ``ml_dtypes``' (``"float32"``,
``"bfloat16"``, ``"float8_e4m3fn"``), so a manifest written here is the
one the JAX package writes for the same arrays.
"""
from __future__ import annotations

import hashlib
import json
import sys
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

MANIFEST_USER_STRING = b"scda-ckpt manifest"
STATUS_USER_STRING = b"scda-ckpt status"
LEAF_USER_PREFIX = "leaf"
FORMAT_VERSION = 1

#: The sharded-set manifest (``repro.checkpoint.sharding``): one small
#: scda file whose block section holds this JSON document instead of a
#: leaf manifest.  Readers tell the two apart by the block's user string,
#: so a sharded manifest can never be misread as a flat checkpoint.
SHARDS_FILE_USER_STRING = b"repro ckpt-shards"
SHARDS_MANIFEST_USER_STRING = b"scda-shards manifest"
SHARDED_FORMAT = "repro-scda-sharded"
SHARDED_VERSION = 1
#: Manifests holding cross-archive chunk references (delta checkpoints).
#: A distinct version so pre-delta readers fail loudly instead of
#: restoring a partial tree from a delta archive they cannot resolve.
DELTA_FORMAT_VERSION = 2
KNOWN_VERSIONS = (FORMAT_VERSION, DELTA_FORMAT_VERSION)

#: Per-chunk content-hash width (SHA-256 prefix, hex).  The 128-bit
#: strong hash alone keys the delta dedup decision — the standard
#: content-addressing assumption (collisions are cryptographically
#: negligible).  The CRC32 travels alongside it as the cheap read-side
#: integrity checksum; a CRC32 collision alone never marks a chunk
#: unchanged, because CRC32 is never consulted for that decision.
#: SHA-256 over blake2b because every x86-64-v3+/ARMv8 host hashes it
#: in hardware — the digest pass is the incremental save's floor cost.
CHUNK_HASH_BYTES = 16


def leaf_user_string(i: int) -> bytes:
    """Deterministic user string of the i-th leaf's section.

    The contract the random-access restore path relies on: a leaf's section
    is addressable by name (via the seekable index) without walking the
    archive, so one tensor can be restored without touching the rest.
    """
    return f"{LEAF_USER_PREFIX} {i:06d}".encode("ascii")

_BYTE_ORDER = "<" if sys.byteorder == "little" else ">"


#: torch dtype <-> manifest name.  The names are what ``np.dtype(d).name``
#: gives for the JAX package's leaves (``ml_dtypes`` names for bf16/fp8),
#: spelled out here because torch's low-precision types have no numpy dtype.
_TORCH_BY_NAME = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAME_BY_TORCH = {v: k for k, v in _TORCH_BY_NAME.items()}


def dtype_name(dtype) -> str:
    """Manifest name of a torch dtype (or of a numpy dtype)."""
    if isinstance(dtype, torch.dtype):
        try:
            return _NAME_BY_TORCH[dtype]
        except KeyError:
            raise ValueError(f"unsupported checkpoint dtype {dtype}") from None
    return np.dtype(dtype).name


def dtype_from_name(name: str) -> torch.dtype:
    """Inverse of :func:`dtype_name`: always a torch dtype."""
    try:
        return _TORCH_BY_NAME[name]
    except KeyError:
        raise ValueError(f"unsupported checkpoint dtype {name!r}") from None


def itemsize(dtype) -> int:
    """Bytes per element of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


class LeafSpec(Dict[str, Any]):
    """A dict with the manifest schema for one array leaf."""

    @staticmethod
    def make(name: str, shape: Tuple[int, ...], dtype,
             compressed: bool, chunk_bytes: Optional[int]) -> "LeafSpec":
        nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize(dtype)
        out = LeafSpec(name=name, shape=list(shape),
                       dtype=dtype_name(dtype), nbytes=int(nbytes),
                       byte_order=_BYTE_ORDER, compressed=bool(compressed))
        if compressed:
            out["chunk_bytes"] = int(chunk_bytes)
        return out


def chunk_hash(chunk) -> str:
    """The per-chunk strong content hash: a 128-bit SHA-256 prefix, hex."""
    return hashlib.sha256(chunk).hexdigest()[:2 * CHUNK_HASH_BYTES]


def chunk_digests(view, sizes: Sequence[int]) \
        -> Tuple[List[int], List[str]]:
    """Per-chunk (CRC32, SHA-256-128) digests of a leaf's byte stream.

    Hashes are taken over the UNCOMPRESSED chunk bytes under the same
    deterministic chunking as §3 compression (:func:`layout.chunk_sizes`),
    so raw and compressed archives hash identically and a chunk's identity
    survives a compression-setting change.
    """
    crcs: List[int] = []
    hashes: List[str] = []
    pos = 0
    for s in sizes:
        chunk = view[pos:pos + s]
        crcs.append(zlib.crc32(chunk) & 0xFFFFFFFF)
        hashes.append(chunk_hash(chunk))
        pos += s
    return crcs, hashes


def chunk_strong_hashes(view, sizes: Sequence[int]) -> List[str]:
    """Strong hashes only — the delta save's decision pass.

    An incremental save hashes every byte (that is its floor cost) but
    checksums only what it stores: CRC32s for stored chunks are computed
    by the planner from the bytes in hand, and unchanged chunks inherit
    the base's CRC32 (sound because hash equality means the bytes are
    identical).  Keeping CRC32 out of this pass roughly halves the
    fixed per-save digest cost on hosts with hardware SHA.
    """
    hashes: List[str] = []
    pos = 0
    for s in sizes:
        hashes.append(chunk_hash(view[pos:pos + s]))
        pos += s
    return hashes


def content_id(doc: Dict[str, Any]) -> str:
    """Deterministic identity of a checkpoint's logical content.

    A blake2b over every leaf's name/geometry/chunk-hash table plus the
    aux tree and step — computable both when the archive is written and
    when it is later opened as a delta base, with no random state (saves
    stay byte-deterministic).  A base file that was rewritten in place
    (same name, different content) therefore no longer matches the id its
    dependents recorded, and chained restores refuse it loudly instead of
    assembling silently wrong tensors.
    """
    payload = {
        "step": doc.get("step"),
        "aux": doc.get("aux", {}),
        "leaves": [[l.get("name"), l.get("shape"), l.get("dtype"),
                    l.get("nbytes"), (l.get("chunks") or {}).get("hash")]
                   for l in doc.get("leaves", [])],
    }
    blob = json.dumps(payload, sort_keys=True).encode("ascii")
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


def document(step: Optional[int], leaves: List[LeafSpec],
             aux: Dict[str, Any],
             delta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The manifest document as a dict — what :func:`build` serializes
    and :func:`parse` returns, so a writer can hand its caller the exact
    doc a re-read of the fresh archive would produce (the manager caches
    it as the next delta's base).

    ``delta``: the cross-archive reference table of an incremental
    checkpoint (``{"bases": [{"file", "id"}, ...], "depth": k}``); its
    presence bumps the manifest to :data:`DELTA_FORMAT_VERSION`.
    """
    doc = {
        "format": "repro-scda-checkpoint",
        "version": DELTA_FORMAT_VERSION if delta else FORMAT_VERSION,
        "step": step,
        "leaves": leaves,
        "aux": aux,   # non-array leaves (python scalars, strings, None)
    }
    if delta:
        doc["delta"] = delta
    return doc


def build(step: Optional[int], leaves: List[LeafSpec],
          aux: Dict[str, Any],
          delta: Optional[Dict[str, Any]] = None) -> bytes:
    """Serialize the manifest to JSON bytes (raw ASCII, human-readable —
    in the spirit of the format's human-friendliness goal)."""
    return json.dumps(document(step, leaves, aux, delta),
                      indent=1, sort_keys=True).encode("ascii")


def parse(raw: bytes) -> Dict[str, Any]:
    doc = json.loads(raw.decode("ascii"))
    if doc.get("format") != "repro-scda-checkpoint":
        raise ValueError(f"not a repro checkpoint manifest: "
                         f"{doc.get('format')!r}")
    if doc.get("version") not in KNOWN_VERSIONS:
        raise ValueError(f"unsupported manifest version {doc.get('version')}")
    return doc


def build_sharded(doc: Dict[str, Any]) -> bytes:
    """Serialize a sharded-set manifest document (same human-readable
    JSON discipline as :func:`build`)."""
    return json.dumps(doc, indent=1, sort_keys=True).encode("ascii")


def parse_sharded(raw: bytes) -> Dict[str, Any]:
    doc = json.loads(raw.decode("ascii"))
    if doc.get("format") != SHARDED_FORMAT:
        raise ValueError(f"not a sharded checkpoint manifest: "
                         f"{doc.get('format')!r}")
    if doc.get("version") != SHARDED_VERSION:
        raise ValueError(
            f"unsupported sharded manifest version {doc.get('version')}")
    return doc


def status_inline(step: Optional[int]) -> bytes:
    """A 32-byte human-readable status for the leading inline section."""
    text = f"step {step if step is not None else '-':>20}\n"
    return text.encode("ascii").ljust(32, b" ")[:32]


def parse_status_inline(data: bytes) -> Optional[int]:
    try:
        token = data.decode("ascii").split()[1]
        return None if token == "-" else int(token)
    except (ValueError, IndexError, UnicodeDecodeError):
        return None
