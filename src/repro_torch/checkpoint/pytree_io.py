"""Flat checkpointing of torch state on scda — the port of the JAX
package's ``repro/checkpoint/pytree_io.py``.

``save`` writes one scda file whose bytes depend only on the *logical*
state (leaf values in canonical row-major order), never on the process
count or the writing partition — the paper's serial-equivalence.  Leaf
names and leaf order are the JAX package's (``jax.tree_util`` order:
dict keys sorted, sequences by index), so a tree of tensors saved here
is byte-identical to ``repro.checkpoint.save`` of the same arrays when
the reference vendor string is passed, and each package restores the
other's files.

Both hot paths are the reference's overlapped pipelines
(:mod:`repro_torch.core.pipeline`): ``write_window=0`` /
``prefetch_bytes=0`` (or ``REPRO_SCDA_WRITE_PIPELINE=0`` /
``REPRO_SCDA_PREFETCH=0``) take the exact serial order, the byte oracles
the pipelines are tested against.  CUDA tensors are snapshotted to host
memory one leaf ahead of the writer; restored leaves land on the device
of their ``like`` leaf (or ``device=``).

Only the flat layout is ported: sharded sets, parity shards and delta
checkpoints raise :class:`NotImplementedError`.

File layout:
    F  header (vendor ``DEFAULT_VENDOR``, or the reference's
       ``b"repro scda-jax 0.1"`` when asked)
    I  "scda-ckpt status"    — human-readable step number
    B  "scda-ckpt manifest"  — JSON: leaf names/shapes/dtypes/layout + aux
    per array leaf, in manifest order:
        raw:        A("leaf NNNNNN", N = nbytes, E = 1)
        compressed: §3.4 convention (A of U-entries + V of deflate chunks),
                    fixed chunking recorded in the manifest
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import layout, manifest as mf, planner
from repro_torch.core import ScdaError, ScdaErrorCode, partition
from repro_torch.core import trace as _trace
from repro_torch.core.comm import Communicator, SerialComm
from repro_torch.core.index import ScdaIndex
from repro_torch.core.io_backend import prefetch_window, write_pipeline_window
from repro_torch.core.pipeline import ReadItem, run_pipeline
from repro_torch.core.reader import ScdaReader, fopen_read
from repro_torch.core.writer import fopen_write

DEFAULT_CHUNK_BYTES = 1 << 20  # 1 MiB deflate chunks for encoded leaves

#: The port's own header vendor.  The JAX package writes
#: :data:`REFERENCE_VENDOR`; pass ``vendor=REFERENCE_VENDOR`` to produce
#: its files byte for byte.
DEFAULT_VENDOR = b"repro scda-torch 0.1"
REFERENCE_VENDOR = b"repro scda-jax 0.1"

#: The reference's knobs for the layouts this port does not carry.
SHARDS_ENV = "REPRO_SCDA_SHARDS"
PARITY_ENV = "REPRO_SCDA_PARITY"


def _effective_prefetch(prefetch_bytes: Optional[int]) -> int:
    """Resolve the prefetch window: explicit argument wins, else the
    ``REPRO_SCDA_PREFETCH`` environment knob (0 = serial restore)."""
    if prefetch_bytes is None:
        return prefetch_window()
    return max(0, int(prefetch_bytes))


def _effective_write_window(write_window: Optional[int]) -> int:
    """Resolve the save-pipeline window: explicit argument wins, else the
    ``REPRO_SCDA_WRITE_PIPELINE`` environment knob (0 = serial save)."""
    if write_window is None:
        return write_pipeline_window()
    return max(0, int(write_window))


#: ``REPRO_SCDA_VERIFY_RESTORE=1``: CRC-check every restored archive
#: against its checksummed sidecar (as if ``restore(..., verify=True)``).
VERIFY_RESTORE_ENV = "REPRO_SCDA_VERIFY_RESTORE"


def _effective_verify(verify: Optional[bool]) -> bool:
    if verify is not None:
        return bool(verify)
    return os.environ.get(VERIFY_RESTORE_ENV, "0") not in ("", "0")


def _env_count(name: str) -> int:
    try:
        return max(0, int(os.environ.get(name, "0")))
    except ValueError:
        return 0


def _verify_archive(path: str) -> None:
    """CRC-check every section payload of ``path`` against its
    checksummed ``.scdax`` sidecar (``scdatool index --checksums``)."""
    try:
        idx = ScdaIndex.load_sidecar(path)
    except (ScdaError, OSError) as e:
        raise ScdaError(
            ScdaErrorCode.ARG_SEQUENCE,
            f"{path}: restore(verify=True) needs a fresh checksummed "
            f"sidecar — run scdatool index --checksums ({e})") from e
    with _trace.span("verify", "ckpt", path=path):
        with fopen_read(None, path) as vr:
            idx.check_checksums(vr)


# --------------------------------------------------------------------------
# Tree flattening with the reference's names and order
# --------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(node, path: Tuple[str, ...], out: List[Tuple[str, Any]]):
    """Walk ``node`` as ``jax.tree_util.tree_flatten_with_path`` does and
    return a function that rebuilds it from an iterator of leaves.

    dicts go in *sorted key* order (the leaf index is part of each
    section's user string, so the order is part of the file's bytes),
    lists and tuples by index, NamedTuples by field, and ``None`` is an
    empty subtree.
    """
    if isinstance(node, dict):
        keys = sorted(node)
        subs = [_flatten(node[k], path + (str(k),), out) for k in keys]
        kind = type(node)
        return lambda it: kind((k, s(it)) for k, s in zip(keys, subs))
    if _is_namedtuple(node):
        subs = [_flatten(getattr(node, f), path + (f,), out)
                for f in node._fields]
        kind = type(node)
        return lambda it: kind(*(s(it) for s in subs))
    if isinstance(node, (list, tuple)):
        subs = [_flatten(v, path + (str(i),), out)
                for i, v in enumerate(node)]
        kind = type(node)
        return lambda it: kind(s(it) for s in subs)
    if node is None:
        return lambda it: None
    out.append(("/".join(path) or ".", node))
    return lambda it: next(it)


def flatten_named(tree) -> Tuple[List[Tuple[str, Any]],
                                 Callable[[List[Any]], Any]]:
    """``[(name, leaf), ...]`` in the reference's order, plus a function
    that rebuilds the tree's structure from a list of leaves."""
    named: List[Tuple[str, Any]] = []
    build = _flatten(tree, (), named)
    names = [n for n, _ in named]
    if len(set(names)) != len(names):
        raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                        "pytree leaf names are not unique")
    return named, lambda leaves: build(iter(leaves))


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


# --------------------------------------------------------------------------
# Saving
# --------------------------------------------------------------------------

def _host_bytes(arr) -> np.ndarray:
    """The canonical row-major bytes of ``arr`` as a host uint8 array.

    A CUDA tensor is copied to host memory here (the counterpart of the
    reference's device→host shard snapshot).  bf16 and fp8 have no numpy
    dtype, so every tensor's bytes move through a ``torch.uint8`` view.
    """
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.device.type != "cpu":
            t = t.to("cpu")
        return t.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def _byte_view(arr) -> memoryview:
    host = _host_bytes(arr)
    if host.nbytes == 0:
        return memoryview(b"")
    return memoryview(host)


def _owned_windows(arr) -> List[Tuple[int, memoryview]]:
    """This process's (byte_offset, buffer) windows of ``arr``: the whole
    leaf, from host memory.  Only the single-process layout is ported, so
    each leaf has one owner and one window."""
    buf = _byte_view(arr)
    return [(0, buf)] if len(buf) else []


def save(path: str, tree, *, comm: Optional[Communicator] = None,
         step: Optional[int] = None, compressed: bool = False,
         chunk_bytes: int = DEFAULT_CHUNK_BYTES,
         aux_extra: Optional[Dict[str, Any]] = None,
         write_window: Optional[int] = None,
         vendor: bytes = DEFAULT_VENDOR,
         delta_base: Optional[Tuple[Dict[str, Any], str]] = None,
         shards: Optional[int] = None,
         parity: Optional[int] = None) -> Dict[str, Any]:
    """Write ``tree`` (nested dicts/lists of tensors) to ``path`` as a
    serial-equivalent scda checkpoint.

    The arguments mean what they mean for ``repro.checkpoint.save``
    (without its content-hash option, which serves delta checkpoints);
    ``vendor`` is the file header's vendor string.  ``shards``, ``parity``
    (or ``REPRO_SCDA_SHARDS`` / ``REPRO_SCDA_PARITY``) and ``delta_base``
    select layouts this port does not carry yet: a non-zero value raises
    :class:`NotImplementedError` rather than writing a different layout
    than asked for.  Returns the manifest document.
    """
    n_shards = _env_count(SHARDS_ENV) if shards is None else int(shards)
    n_parity = _env_count(PARITY_ENV) if parity is None else int(parity)
    if n_shards or n_parity or delta_base is not None:
        raise NotImplementedError(
            "sharded, parity and delta checkpoints are not ported yet "
            f"(shards={n_shards}, parity={n_parity}, "
            f"delta_base={'set' if delta_base is not None else None})")
    comm = comm or SerialComm()
    with _trace.span("save", "ckpt", path=path, step=step, shards=0,
                     parity=0, compressed=compressed):
        named, _ = flatten_named(tree)
        leaves: List[mf.LeafSpec] = []
        arrays: List[Any] = []
        aux: Dict[str, Any] = dict(aux_extra or {})
        for name, value in named:
            if _is_array(value):
                leaves.append(mf.LeafSpec.make(
                    name, tuple(value.shape), value.dtype,
                    compressed, chunk_bytes))
                arrays.append(value)
            else:
                aux[name] = _encode_aux(value)
        return _write_checkpoint(
            path, comm=comm, step=step, leaves=leaves, arrays=arrays,
            aux=aux, compressed=compressed, chunk_bytes=chunk_bytes,
            write_window=write_window, vendor=vendor)


def _write_checkpoint(path: str, *, comm: Communicator,
                      step: Optional[int], leaves: List[mf.LeafSpec],
                      arrays: List[Any], aux: Dict[str, Any],
                      compressed: bool, chunk_bytes: int,
                      write_window: Optional[int],
                      vendor: bytes) -> Dict[str, Any]:
    """Flattened leaves → placement plan → archive (the reference's
    ``_write_checkpoint`` without the content-hash and delta legs)."""
    ww = _effective_write_window(write_window)
    if compressed and comm.size > 1:
        raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                        "compressed checkpoints require chunk-aligned "
                        "partitions; use comm.size == 1 (async snapshot)")

    placements: List[planner.LeafPlacement] = []
    for i, (spec_, arr) in enumerate(zip(leaves, arrays)):
        user = mf.leaf_user_string(i)
        if compressed:
            sizes = layout.chunk_sizes(spec_["nbytes"], chunk_bytes)

            def snapshot(arr=arr, sizes=sizes):
                flat = _byte_view(arr)
                chunks, pos = [], 0
                for s in sizes:
                    chunks.append(flat[pos:pos + s])
                    pos += s
                return chunks

            placements.append(planner.ChunkPlacement(
                user, sizes, snapshot, True, key=i))
        else:
            def snapshot(arr=arr):
                return _owned_windows(arr)

            placements.append(planner.WindowPlacement(
                user, spec_["nbytes"], snapshot, key=i))

    # sync=True: a checkpoint is durable before save returns.
    with _trace.span("write_archive", "ckpt", path=path,
                     sections=len(placements)):
        with fopen_write(comm, path, user_string=b"repro checkpoint",
                         vendor=vendor, sync=True) as f:
            f.write_inline(mf.STATUS_USER_STRING, mf.status_inline(step),
                           root=0)
            f.write_block(
                mf.MANIFEST_USER_STRING,
                mf.build(step, leaves, aux) if comm.rank == 0 else None,
                E=None, root=0)
            planner.write_placements(f, placements, ww)
    return mf.document(step, leaves, aux)


def _encode_aux(value) -> Any:
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                    f"unsupported non-array leaf type {type(value)!r}")


# --------------------------------------------------------------------------
# Restoring
# --------------------------------------------------------------------------

def _read_header_sections(r: ScdaReader) -> Dict[str, Any]:
    """Consume the leading status + manifest sections; returns the doc."""
    hdr = r.read_section_header()
    if hdr.type != "I" or hdr.user_string != mf.STATUS_USER_STRING:
        raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                        "not a repro checkpoint: missing status inline")
    step = mf.parse_status_inline(r.read_inline_data())
    hdr = r.read_section_header()
    if hdr.type != "B":
        raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                        "not a repro checkpoint: missing manifest block")
    if hdr.user_string == mf.MANIFEST_USER_STRING:
        doc = mf.parse(r.read_block_data())
    elif hdr.user_string == mf.SHARDS_MANIFEST_USER_STRING:
        doc = mf.parse_sharded(r.read_block_data())
    else:
        raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                        "not a repro checkpoint: missing manifest block")
    if doc.get("step") is None:
        doc["step"] = step
    return doc


def _check_flat(doc: Dict[str, Any], path: str) -> None:
    if doc.get("format") == mf.SHARDED_FORMAT:
        raise NotImplementedError(
            f"{path}: sharded checkpoint sets are not ported yet")
    if doc.get("delta"):
        raise NotImplementedError(
            f"{path}: delta checkpoints are not ported yet")


def _resolve_index(r: ScdaReader) -> ScdaIndex:
    """The reader's index, salvaging a valid prefix on a torn tail."""
    try:
        return r.index()
    except ScdaError as e:
        if e.group != 1:
            raise
        idx = ScdaIndex.build_prefix(r)
        idx._salvage_error = e
        r.set_index(idx)
        return idx


def _adopt_sidecar(r: ScdaReader) -> None:
    """Give the reader a fresh ``.scdax`` index if one exists (purely an
    optimization: every seek re-checks the on-disk header)."""
    try:
        r.set_index(ScdaIndex.load_sidecar(r.path))
    except (ScdaError, OSError):
        pass


def read_manifest(path: str, comm: Optional[Communicator] = None) \
        -> Dict[str, Any]:
    """Read just the status + manifest (cheap metadata probe)."""
    with fopen_read(comm, path) as r:
        return _read_header_sections(r)


def _target_device(target, device) -> torch.device:
    """Where a restored leaf goes: ``device`` if given, else the device of
    its ``like`` leaf (a meta tensor means the host)."""
    if device is not None:
        return torch.device(device)
    if isinstance(target, torch.Tensor) and target.device.type != "meta":
        return target.device
    return torch.device("cpu")


def restore(path: str, like=None, *, device=None,
            comm: Optional[Communicator] = None,
            prefetch_bytes: Optional[int] = None,
            verify: Optional[bool] = None):
    """Restore a checkpoint; returns ``(tree, step)``.

    ``like``: a tree of tensors (meta tensors will do) giving the target
    structure; each leaf lands on its ``like`` leaf's device, or on
    ``device`` when that is given.  The leaf dtype is the checkpoint's.
    With ``like=None`` a nested dict is rebuilt from the manifest names,
    on ``device`` (default: the host).  With ``like`` the restore is lazy:
    only the wanted leaves' sections are read.

    Reads run through the overlapped restore engine (``prefetch_bytes``,
    default ``REPRO_SCDA_PREFETCH``); ``prefetch_bytes=0`` restores
    serially (the byte oracle).  ``verify=True`` CRC-checks the archive
    against its checksummed sidecar first.
    """
    comm = comm or SerialComm()
    pf = _effective_prefetch(prefetch_bytes)
    with _trace.span("restore", "ckpt", path=path):
        if _effective_verify(verify):
            _verify_archive(path)
        with fopen_read(comm, path) as r:
            doc = _read_header_sections(r)
            _check_flat(doc, path)
            return _restore_from_reader(r, doc, like, pf, device)


def _restore_from_reader(r: ScdaReader, doc: Dict[str, Any], like,
                         pf: int, device):
    step = doc.get("step")
    by_name: Dict[str, Any] = {}
    for i, spec_ in enumerate(doc["leaves"]):
        by_name[spec_["name"]] = (i, spec_)

    if like is None:
        out: Dict[str, Any] = {}
        if pf > 0 and doc["leaves"]:
            _adopt_sidecar(r)
            wanted = [(spec_["name"], i, spec_, None)
                      for i, spec_ in enumerate(doc["leaves"])]
            out = _restore_pipelined(r, wanted, pf, device)
        else:
            # Serial oracle: the forward walk touches every byte in
            # file order, one section at a time.
            for spec_ in doc["leaves"]:
                hdr = r.read_section_header()
                _check_leaf_header(hdr, spec_)
                out[spec_["name"]] = _to_device(
                    _read_leaf_full(r, spec_), None, device)
        for name, value in doc["aux"].items():
            out[name] = value
        return _unflatten_names(out), step

    named, rebuild = flatten_named(like)
    targets = {n: v for n, v in named}
    missing = [n for n in targets
               if n not in by_name and n not in doc["aux"]]
    if missing:
        raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                        f"leaves missing from checkpoint: {missing[:5]}"
                        f"{'…' if len(missing) > 5 else ''}")
    _adopt_sidecar(r)
    if pf > 0:
        wanted = [(name,) + by_name[name] + (targets[name],)
                  for name in targets if name in by_name]
        values = _restore_pipelined(r, wanted, pf, device)
    else:
        values = {}
        for name in targets:
            if name not in by_name:
                continue  # aux leaf
            i, spec_ = by_name[name]
            hdr = r.open_section(mf.leaf_user_string(i))
            _check_leaf_header(hdr, spec_)
            values[name] = _read_leaf_to_target(r, spec_,
                                                targets[name], device)
    for name in targets:
        if name in doc["aux"]:
            values[name] = doc["aux"][name]
    return rebuild([values[n] for n, _ in named]), step


def restore_leaf(path: str, name: str, like=None, *, device=None,
                 comm: Optional[Communicator] = None,
                 prefetch_bytes: Optional[int] = None,
                 verify: Optional[bool] = None):
    """Load ONE leaf from a checkpoint without touching the rest.

    Seeks straight to the leaf's section and reads only its bytes.
    ``like`` (a tensor) or ``device`` says where it lands, as in
    :func:`restore`.  Aux (non-array) leaves come from the manifest.
    """
    comm = comm or SerialComm()
    pf = _effective_prefetch(prefetch_bytes)
    with _trace.span("restore_leaf", "ckpt", path=path, leaf=name):
        if _effective_verify(verify):
            _verify_archive(path)
        with fopen_read(comm, path) as r:
            doc = _read_header_sections(r)
            _check_flat(doc, path)
            for i, spec_ in enumerate(doc["leaves"]):
                if spec_["name"] != name:
                    continue
                _adopt_sidecar(r)
                if pf > 0:
                    return _restore_pipelined(
                        r, [(name, i, spec_, like)], pf, device)[name]
                hdr = r.open_section(mf.leaf_user_string(i))
                _check_leaf_header(hdr, spec_)
                return _read_leaf_to_target(r, spec_, like, device)
            if name in doc["aux"]:
                return doc["aux"][name]
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                            f"leaf {name!r} not in checkpoint")


def _check_leaf_header(hdr, spec_) -> None:
    if spec_.get("store") == "delta":
        raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                        f"leaf {spec_['name']}: delta-stored leaf outside "
                        f"the chain resolver")
    if spec_["compressed"]:
        if hdr.type != "V" or hdr.N != len(layout.chunk_sizes(
                spec_["nbytes"], spec_["chunk_bytes"])):
            raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                            f"leaf {spec_['name']}: bad compressed section")
    else:
        if hdr.type != "A" or hdr.N != spec_["nbytes"] or hdr.E != 1:
            raise ScdaError(ScdaErrorCode.CORRUPT_ENCODING,
                            f"leaf {spec_['name']}: bad array section "
                            f"({hdr.type} N={hdr.N} E={hdr.E})")


def _check_target_shape(spec_, target) -> None:
    if target is None:
        return
    shape = tuple(spec_["shape"])
    t_shape = tuple(getattr(target, "shape", np.shape(target)))
    if t_shape != shape:
        raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                        f"leaf {spec_['name']}: target shape {t_shape} != "
                        f"checkpoint shape {shape}")


def _as_tensor(raw: np.ndarray, spec_) -> torch.Tensor:
    """Host uint8 bytes → a CPU tensor of the manifest's dtype and shape
    (through a ``torch.uint8`` view: no numpy bf16 needed)."""
    dtype = mf.dtype_from_name(spec_["dtype"])
    return torch.from_numpy(raw).view(dtype).reshape(spec_["shape"])


def _to_device(t: torch.Tensor, target, device) -> torch.Tensor:
    dev = _target_device(target, device)
    return t if dev.type == "cpu" else t.to(dev)


# --------------------------------------------------------------------------
# The overlapped restore engine's checkpoint scheduler
# --------------------------------------------------------------------------

def _restore_pipelined(r: ScdaReader, wanted, prefetch_bytes: int,
                       device) -> Dict[str, Any]:
    """Restore ``wanted`` leaves ``(name, manifest_index, spec, target)``
    through the overlapped engine: raw leaves read straight into their
    host buffers, compressed leaves inflate on the codec pool, all reads
    sorted by file offset and prefetched ``prefetch_bytes`` ahead.
    Byte-identical to the serial walk — only the schedule changes."""
    idx = _resolve_index(r)
    backend = r._backend
    bufs: List[np.ndarray] = []
    items: List[ReadItem] = []
    for pos, (name, i, spec_, target) in enumerate(wanted):
        user = mf.leaf_user_string(i)
        sec = idx.find(user)
        if sec < 0:
            salvage = getattr(idx, "_salvage_error", None)
            if salvage is not None:
                raise salvage
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                            f"no section with user string {user!r} "
                            f"(occurrence 0)")
        e = idx.entries[sec]
        r.verify_index_entry(sec, e)
        _check_leaf_header(e.header(), spec_)
        _check_target_shape(spec_, target)
        nbytes = spec_["nbytes"]
        # Uninitialized on purpose: every byte is covered by the run or
        # the chunk spans below.
        buf = np.empty(nbytes, np.uint8)
        bufs.append(buf)
        if not nbytes:
            continue
        if spec_["compressed"]:
            csizes = r._parse_entries(e.v_entries_start, 0, e.N, b"E")
            offs = partition.offsets(csizes)
            usizes = r._parse_entries(e.entries_start, 0, e.N, b"U")
            needed = list(range(e.N))
            items.append(ReadItem(
                (pos, True),
                [(e.v_data_start + offs[c], csizes[c]) for c in needed],
                inflate=True, expected_sizes=[usizes[c] for c in needed]))
        else:
            items.append(ReadItem((pos, False), [(e.data_start, nbytes)],
                                  dst=[memoryview(buf)]))

    items.sort(key=lambda it: it.start())
    for (pos, compressed), res in run_pipeline(backend, items,
                                               prefetch_bytes):
        if compressed:
            _fill_joined(res, bufs[pos], wanted[pos][2])
    return {name: _to_device(_as_tensor(buf, spec_), target, device)
            for (name, _, spec_, target), buf in zip(wanted, bufs)}


def _fill_joined(chunks: List[bytes], arr: np.ndarray, spec_) -> None:
    """Inflated chunks concatenated in element order into ``arr``, the
    total checked against the manifest (the serial reader's join)."""
    total = sum(map(len, chunks))
    if total != spec_["nbytes"]:
        raise ScdaError(ScdaErrorCode.CORRUPT_CHECKSUM,
                        f"leaf {spec_['name']}: {total} bytes, "
                        f"manifest says {spec_['nbytes']}")
    pos = 0
    for c in chunks:
        if len(c):
            arr[pos:pos + len(c)] = np.frombuffer(c, np.uint8)
            pos += len(c)


def _read_leaf_full(r: ScdaReader, spec_) -> torch.Tensor:
    if spec_["compressed"]:
        sizes = layout.chunk_sizes(spec_["nbytes"], spec_["chunk_bytes"])
        raw = b"".join(r.read_varray_elements(list(range(len(sizes)))))
    else:
        raw = b"".join(r.read_array_windows([(0, spec_["nbytes"])], 1))
    r.skip_data()
    if len(raw) != spec_["nbytes"]:
        raise ScdaError(ScdaErrorCode.CORRUPT_CHECKSUM,
                        f"leaf {spec_['name']}: {len(raw)} bytes, "
                        f"manifest says {spec_['nbytes']}")
    return _as_tensor(np.frombuffer(raw, np.uint8).copy(), spec_)


def _read_leaf_to_target(r: ScdaReader, spec_, target, device):
    _check_target_shape(spec_, target)
    return _to_device(_read_leaf_full(r, spec_), target, device)


def _unflatten_names(flat: Dict[str, Any]):
    """Rebuild a nested dict from 'a/b/c' names (like=None restores)."""
    root: Dict[str, Any] = {}
    for name, value in flat.items():
        parts = name.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root
