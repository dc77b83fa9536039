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

``shards`` splits a save into a set of independent archives
(:mod:`repro_torch.checkpoint.sharding`), ``parity`` adds erasure-code
shards over them (:mod:`repro_torch.checkpoint.redundancy`), and
``record_hashes`` / ``delta_base`` write content digests and incremental
saves (:mod:`repro_torch.checkpoint.delta`).  ``restore`` resolves a set's
manifest and a delta's chain, as the reference's does.

DTensor leaves are the counterpart of the reference's sharded
``jax.Array``s: saved by the ranks of a ``TorchDistComm``, each rank
writes the bytes of its local shard that no lower replica holds, so
across ranks every byte of a leaf has one writer and the file is the one
a single process writes; a DTensor in ``like`` (its local tensor may be
on the ``meta`` device) restores each rank's shard from the span of the
leaf it covers, never the whole leaf unless the shard spans it.
Compressed, content-hashed and delta saves stay single-rank, as in the
reference.

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

import dataclasses
import math
import mmap
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import layout, manifest as mf, planner
from repro_torch.core import ScdaError, ScdaErrorCode, partition
from repro_torch.core.errors import os_error_detail
from repro_torch.core import spec as _spec
from repro_torch.core import trace as _trace
from repro_torch.core.comm import Communicator, SerialComm
from repro_torch.core.index import ScdaIndex
from repro_torch.core.io_backend import prefetch_window, write_pipeline_window
from repro_torch.core.pipeline import ReadItem, WriteItem, run_pipeline
from repro_torch.runtime import is_dtensor as _is_dtensor
from repro_torch.core.reader import ScdaReader, fopen_read
from repro_torch.core.writer import fopen_write

DEFAULT_CHUNK_BYTES = 1 << 20  # 1 MiB deflate chunks for encoded leaves

#: The port's own header vendor.  The JAX package writes
#: :data:`REFERENCE_VENDOR`; pass ``vendor=REFERENCE_VENDOR`` to produce
#: its files byte for byte.
DEFAULT_VENDOR = b"repro scda-torch 0.1"
REFERENCE_VENDOR = b"repro scda-jax 0.1"

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

def _local_block(t) -> Tuple[Tuple[int, ...], Tuple[int, ...], bool]:
    """This rank's block of the DTensor ``t``: its local shape, its offset
    in the global tensor, and whether this rank owns it for a save — it
    does where its mesh coordinate is 0 on every ``Replicate`` mesh dim,
    the counterpart of the reference's ``replica_id == 0``.  A rank off
    the mesh holds an empty block."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pls = t.device_mesh, tuple(t.placements)
    for p in pls:
        if type(p) is not Shard and not isinstance(p, Replicate):
            raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                            f"DTensor placement {p} is not Shard or "
                            f"Replicate: its local tensor is not a block "
                            f"of the value")
    shape = tuple(t.shape)
    coord = mesh.get_coordinate()
    if coord is None:
        return tuple(0 for _ in shape), tuple(0 for _ in shape), False
    lshape, offset = compute_local_shape_and_global_offset(shape, mesh, pls)
    owned = all(c == 0 for c, p in zip(coord, pls)
                if isinstance(p, Replicate))
    return tuple(lshape), tuple(offset), owned


def _block_runs(shape, lshape, offset, itemsize: int) -> List[layout.Run]:
    """The block's contiguous runs in the canonical byte stream: what
    ``layout.shard_runs`` gives for it, computed with numpy (a block under
    tensor-parallel placements has hundreds of thousands)."""
    shape, lshape, offset = list(shape), list(lshape), list(offset)
    if not shape:
        return [(0, 0, itemsize)]
    if 0 in lshape or 0 in shape:
        return []
    k = len(shape) - 1   # the last dim the block does not span whole
    while k >= 0 and offset[k] == 0 and lshape[k] == shape[k]:
        k -= 1
    if k < 0:
        return [(0, 0, math.prod(shape) * itemsize)]
    strides = _byte_strides(shape, itemsize)
    run = lshape[k] * strides[k]
    starts = np.asarray(offset[k] * strides[k], np.int64)
    for d in range(k):
        starts = np.add.outer(starts, (offset[d] + np.arange(
            lshape[d], dtype=np.int64)) * strides[d])
    starts = starts.reshape(-1)   # dims 0..k-1 in row-major order
    return list(zip(starts.tolist(), range(0, run * len(starts), run),
                    [run] * len(starts)))


#: A block is read in slabs along its first dim, each slab as ONE span of
#: the file from its first byte to its last (the gaps between its runs
#: included) — a few large reads in place of one per run, which under
#: tensor-parallel placements are a KiB each; a slab's span is about this
#: many bytes, at least one row of the global tensor's first dim.
SLAB_BYTES = 8 << 20


def _byte_strides(shape, itemsize: int) -> List[int]:
    out, acc = [], itemsize
    for dim in reversed(shape):
        out.append(acc)
        acc *= dim
    return out[::-1]


def _as_1d(shape, lshape, offset):
    """A 0-d leaf as a 1-d leaf of one element: the same bytes."""
    if not len(shape):
        return (1,), (1,), (0,)
    return tuple(shape), tuple(lshape), tuple(offset)


def _block_slabs(shape, lshape, offset, itemsize: int) \
        -> List[Tuple[int, int, int, int]]:
    """``(first row, end row, span start, span bytes)`` of each slab of the
    block along its first dim."""
    shape, lshape, offset = _as_1d(shape, lshape, offset)
    if 0 in lshape:
        return []
    strides = _byte_strides(shape, itemsize)
    base = sum(o * st for o, st in zip(offset, strides))
    tail = sum((n - 1) * st for n, st in zip(lshape[1:], strides[1:])) \
        + itemsize
    rows = max(1, SLAB_BYTES // strides[0])
    return [(i, min(i + rows, lshape[0]), base + i * strides[0],
             (min(i + rows, lshape[0]) - 1 - i) * strides[0] + tail)
            for i in range(0, lshape[0], rows)]


def _slab_views(block: np.ndarray, span: np.ndarray, shape, lshape,
                itemsize: int, rows, writeable: bool = False):
    """The block's rows ``rows`` twice: in ``block`` (its bytes in
    row-major order) and in ``span`` (uint8, from the rows' first byte in
    the canonical stream) viewed with the global tensor's strides.  One
    numpy assignment between the two copies the rows either way."""
    shape, lshape, _ = _as_1d(shape, lshape, ())
    i0, i1 = rows
    in_span = np.lib.stride_tricks.as_strided(
        span, shape=(i1 - i0,) + lshape[1:] + (itemsize,),
        strides=tuple(_byte_strides(shape, itemsize)) + (1,),
        writeable=writeable)
    return block.reshape(lshape + (itemsize,))[i0:i1], in_span


def _host_bytes(arr) -> np.ndarray:
    """The canonical row-major bytes of ``arr`` as a host uint8 array.

    A CUDA tensor is copied to host memory here (the counterpart of the
    reference's device→host shard snapshot).  bf16 and fp8 have no numpy
    dtype, so every tensor's bytes move through a ``torch.uint8`` view.
    A DTensor reaches here only on a mesh of one rank (``_write_checkpoint``
    refuses the others), where its local tensor is the whole.
    """
    if _is_dtensor(arr):
        arr = arr.to_local()
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
    """This process's (byte_offset, buffer) windows of the plain tensor
    ``arr``: the whole leaf, from host memory, as a numpy array is wholly
    owned in the reference.  A DTensor leaf is written by
    :class:`_ShardPlacement`."""
    buf = _byte_view(arr)
    return [(0, buf)] if len(buf) else []


@dataclasses.dataclass
class _ShardPlacement(planner.LeafPlacement):
    """A DTensor leaf's ``A(user, N=nbytes, E=1)`` section, written by
    every rank of the save: the bytes of :class:`planner.WindowPlacement`
    with the runs of each rank's owned block (:func:`_local_block`,
    :func:`_block_runs`) as its windows, by another route.  The writer
    plans the header and, on the rank whose block holds the leaf's last
    element, that element with the padding after it; the rank's block is
    copied into a shared mapping of its span of the archive, one strided
    numpy copy a slab (:func:`_map_block`), the archive having been sized
    and its blocks allocated before any section (:func:`_presize`).
    Under tensor-parallel placements a rank's block is hundreds of
    thousands of KiB-long runs: one positioned write each took 36–53 s a
    save of qwen3-1.7b's weights on an H100 machine's disk.  The copies
    are durable with the rest: the writer's close fsyncs the descriptor,
    which writes back the mapped pages too."""

    user: bytes
    nbytes: int
    leaf: Any    # the DTensor
    key: Any = None

    def snapshot(self):
        """``[((local shape, offset), host bytes)]`` of this rank's block,
        or ``[]`` where it owns none (a replica, an empty block)."""
        lshape, offset, owned = _local_block(self.leaf)
        if not owned or not self.nbytes or 0 in lshape:
            return []
        return [((lshape, offset), _host_bytes(self.leaf.to_local()))]

    def _plan(self, f, snap, cursor: int):
        shape, itemsize = tuple(self.leaf.shape), self.leaf.dtype.itemsize
        last = []
        for (lshape, offset), host in snap:
            if all(o + n == d for o, n, d in zip(offset, lshape, shape)):
                last = [(self.nbytes - itemsize,
                         memoryview(host)[-itemsize:])]
        frags, end = f.plan_array_windows(self.user, last, N=self.nbytes,
                                          E=1, cursor=cursor)
        for (lshape, offset), host in snap:
            _map_block(f._backend, end - _spec.padded_data_bytes(
                self.nbytes), shape, itemsize, lshape, offset, host)
        return frags, end

    def write_serial(self, f) -> None:
        frags, f.cursor = self._plan(f, self.snapshot(), f.cursor)
        f._backend.write_gather(frags)

    def write_item(self, f, cursor: List[int]) -> WriteItem:
        def plan(snap):
            frags, cursor[0] = self._plan(f, snap, cursor[0])
            return frags
        return WriteItem(key=self.key, snapshot=self.snapshot, plan=plan,
                         style=f.style)


def _map_block(backend, data_start: int, shape, itemsize: int, lshape,
               offset, host: np.ndarray) -> None:
    """Copy a block's bytes ``host`` to its place in the section whose
    data starts at ``data_start``, through one shared mapping of the span
    the block covers (the archive already reaches its end)."""
    slabs = _block_slabs(shape, lshape, offset, itemsize)
    lo = data_start + slabs[0][2]
    hi = data_start + slabs[-1][2] + slabs[-1][3]
    base = lo - lo % mmap.ALLOCATIONGRANULARITY
    try:
        mm = mmap.mmap(backend.fd, hi - base, offset=base)
    except OSError as e:
        raise ScdaError(ScdaErrorCode.FS_WRITE,
                        os_error_detail(backend.path, base, e),
                        offset=base) from e
    _copy_slabs(np.frombuffer(mm, np.uint8), data_start - base, slabs,
                shape, lshape, itemsize, host)
    mm.close()   # no view of it is left: they died with _copy_slabs


def _copy_slabs(mapped: np.ndarray, shift: int, slabs, shape, lshape,
                itemsize: int, host: np.ndarray) -> None:
    """Each slab of ``host`` into ``mapped``, whose byte 0 is the
    section's data byte ``-shift``."""
    for i0, i1, start, _ in slabs:
        src, dst = _slab_views(host, mapped[shift + start:], shape, lshape,
                               itemsize, (i0, i1), writeable=True)
        dst[...] = src


def _reserve(backend, n: int) -> None:
    """Extend the archive to ``n`` bytes through the backend's
    instrumented truncate (fault plans' ``truncate`` rules reach it), then
    allocate its blocks, so that a full disk is FS_WRITE here and never a
    fault on a page written through a mapping of the file."""
    backend.truncate(n)
    try:
        os.posix_fallocate(backend.fd, 0, n)
    except OSError as e:
        raise ScdaError(ScdaErrorCode.FS_WRITE,
                        os_error_detail(backend.path, n, e), offset=n) from e


def _presize(f, placements, comm: Communicator) -> None:
    """Give the archive its final size, its blocks allocated, before any
    section is written, so that :func:`_map_block` never maps past its
    end nor meets a full disk: every section is a raw window section
    here, whose extent the writer plans without data.  Rank 0 reserves
    the file; every rank raises its error (FS_WRITE for a full disk)."""
    end = f.cursor
    for p in placements:
        _, end = f.plan_array_windows(p.user, [], N=p.nbytes, E=1,
                                      cursor=end)
    err = None
    if comm.rank == 0:
        try:
            _reserve(f._backend, end)
        except ScdaError as e:
            err = e
    code_detail = comm.bcast(None if err is None
                             else (int(err.code), err.detail), root=0)
    if err is not None:
        raise err
    if code_detail is not None:
        raise ScdaError(code_detail[0], f"rank 0: {code_detail[1]}")


def save(path: str, tree, *, comm: Optional[Communicator] = None,
         step: Optional[int] = None, compressed: bool = False,
         chunk_bytes: int = DEFAULT_CHUNK_BYTES,
         aux_extra: Optional[Dict[str, Any]] = None,
         write_window: Optional[int] = None,
         vendor: bytes = DEFAULT_VENDOR,
         record_hashes: bool = False,
         delta_base: Optional[Tuple[Dict[str, Any], str]] = None,
         shards: Optional[int] = None,
         parity: Optional[int] = None) -> Dict[str, Any]:
    """Write ``tree`` (nested dicts/lists of tensors) to ``path`` as a
    serial-equivalent scda checkpoint.

    The arguments mean what they mean for ``repro.checkpoint.save``;
    ``vendor`` is the header's vendor string of every file written (each
    shard, the set manifest and each parity file of a set).

    ``record_hashes`` adds per-chunk digests (CRC32 and a 128-bit SHA-256
    prefix) to the manifest, so the archive can serve as a delta base;
    ``delta_base`` (a ``(base_manifest_doc, base_file_name)`` pair) stores
    only the chunks whose digests differ from the base's.  Both are
    single-rank.  ``shards`` (``None``: ``REPRO_SCDA_SHARDS``) splits the
    save into that many archives plus a manifest file at ``path``, and
    ``parity`` (``None``: ``REPRO_SCDA_PARITY``; ignored for a flat save)
    adds that many erasure-code shards.  Returns the manifest document
    (a sharded save's, with its shards' docs under ``shard_docs``).
    """
    from repro_torch.checkpoint import redundancy as _red
    from repro_torch.checkpoint import sharding as _sharding
    comm = comm or SerialComm()
    n_shards = _sharding.shards_default() if shards is None else \
        max(0, int(shards))
    n_parity = _red.parity_default() if parity is None else \
        max(0, int(parity))
    with _trace.span("save", "ckpt", path=path, step=step,
                     shards=n_shards, parity=n_parity,
                     compressed=compressed):
        if n_shards:
            _red.check_geometry(n_shards, n_parity)
            return _sharding.save_sharded(
                path, tree, shards=n_shards, comm=comm, step=step,
                compressed=compressed, chunk_bytes=chunk_bytes,
                aux_extra=aux_extra, write_window=write_window,
                record_hashes=record_hashes, delta_base=delta_base,
                parity=n_parity, vendor=vendor)
        leaves, arrays, aux = _split_leaves(tree, compressed, chunk_bytes,
                                            aux_extra)
        return _write_checkpoint(
            path, comm=comm, step=step, leaves=leaves, arrays=arrays,
            aux=aux, compressed=compressed, chunk_bytes=chunk_bytes,
            write_window=write_window, vendor=vendor,
            record_hashes=record_hashes, delta_base=delta_base)


def _split_leaves(tree, compressed: bool, chunk_bytes: int,
                  aux_extra: Optional[Dict[str, Any]]):
    """``tree`` flattened into array leaf specs, the arrays, and the aux
    (non-array) leaves."""
    named, _ = flatten_named(tree)
    leaves: List[mf.LeafSpec] = []
    arrays: List[Any] = []
    aux: Dict[str, Any] = dict(aux_extra or {})
    for name, value in named:
        if _is_array(value):
            leaves.append(mf.LeafSpec.make(
                name, tuple(value.shape), value.dtype, compressed,
                chunk_bytes))
            arrays.append(value)
        else:
            aux[name] = _encode_aux(value)
    return leaves, arrays, aux


def _write_checkpoint(path: str, *, comm: Communicator,
                      step: Optional[int], leaves: List[mf.LeafSpec],
                      arrays: List[Any], aux: Dict[str, Any],
                      compressed: bool, chunk_bytes: int,
                      write_window: Optional[int],
                      vendor: bytes, record_hashes: bool = False,
                      delta_base: Optional[Tuple[Dict[str, Any], str]]
                      = None) -> Dict[str, Any]:
    """The save core shared by :func:`save`, each shard of a set and
    ``squash``: flattened leaves → digests → placement plan → archive.
    Given the same inputs the bytes are the same whatever the caller."""
    ww = _effective_write_window(write_window)
    if compressed and comm.size > 1:
        raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                        "compressed checkpoints require chunk-aligned "
                        "partitions; use comm.size == 1 (async snapshot)")
    if (record_hashes or delta_base is not None) and comm.size > 1:
        raise ScdaError(ScdaErrorCode.ARG_SEQUENCE,
                        "content-hashed / delta checkpoints are "
                        "single-rank; use comm.size == 1 (async snapshot)")
    if comm.size == 1:
        for spec_, arr in zip(leaves, arrays):
            if _is_dtensor(arr) and arr.device_mesh.size() > 1:
                raise ScdaError(
                    ScdaErrorCode.ARG_SEQUENCE,
                    f"leaf {spec_['name']}: a DTensor over "
                    f"{arr.device_mesh.size()} ranks saved by one rank; "
                    f"pass comm=TorchDistComm() on every rank")

    if record_hashes or delta_base is not None:
        # Digests are taken over the host snapshot, and the same host
        # bytes are the sections' payloads: one device→host copy a leaf.
        # The delta leg takes the strong hash only; its CRC32s are filled
        # in by plan_refs (computed for stored chunks, inherited from the
        # base for unchanged ones), so its cost follows the changed bytes.
        hosts: List[np.ndarray] = []
        for spec_, arr in zip(leaves, arrays):
            host = _host_bytes(arr)
            sizes = layout.chunk_sizes(spec_["nbytes"], chunk_bytes)
            view = _byte_view(host)
            if delta_base is not None:
                spec_["chunks"] = {
                    "bytes": int(chunk_bytes),
                    "hash": mf.chunk_strong_hashes(view, sizes)}
            else:
                crcs, hashes = mf.chunk_digests(view, sizes)
                spec_["chunks"] = {"bytes": int(chunk_bytes),
                                   "crc32": crcs, "hash": hashes}
            hosts.append(host)
        arrays = hosts
    delta_table: Optional[Dict[str, Any]] = None
    if delta_base is not None:
        from repro_torch.checkpoint import delta as _delta
        base_doc, base_file = delta_base
        delta_table = _delta.plan_refs(
            leaves, base_doc, base_file,
            views=[_byte_view(h) for h in arrays])

    placements: List[planner.LeafPlacement] = []
    for i, (spec_, arr) in enumerate(zip(leaves, arrays)):
        user = mf.leaf_user_string(i)
        sizes = layout.chunk_sizes(spec_["nbytes"], chunk_bytes)
        if delta_table is not None:
            present = spec_["present"]
            if not present:
                continue  # unchanged leaf: references only, no section

            def snapshot(arr=arr, present=present, sizes=sizes):
                flat = _byte_view(arr)
                return [flat[c * chunk_bytes:c * chunk_bytes + sizes[c]]
                        for c in present]

            placements.append(planner.ChunkPlacement(
                user, [sizes[c] for c in present], snapshot, compressed,
                key=i))
        elif compressed:
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

            placements.append(
                _ShardPlacement(user, spec_["nbytes"], arr, key=i)
                if _is_dtensor(arr) else planner.WindowPlacement(
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
                mf.build(step, leaves, aux, delta_table)
                if comm.rank == 0 else None,
                E=None, root=0)
            if any(isinstance(p, _ShardPlacement) for p in placements):
                _presize(f, placements, comm)
            planner.write_placements(f, placements, ww)
    return mf.document(step, leaves, aux, delta_table)


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
    its ``like`` leaf (a meta tensor means the host; a DTensor's, the
    current device of its mesh's type)."""
    if device is not None:
        return torch.device(device)
    if _is_dtensor(target):
        if target.to_local().device.type != "meta":
            return target.to_local().device
        kind = target.device_mesh.device_type
        if kind == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(kind)
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
    A DTensor leaf of ``like`` (``distributed.sharding.params_shardings``
    makes them) restores as a DTensor with its mesh and placements: each
    rank reads only the span its local shard covers, in slabs of about
    :data:`SLAB_BYTES` (for a compressed leaf, only the chunks that overlap
    the shard's runs), and no collective runs.
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
    vfy = _effective_verify(verify)
    with _trace.span("restore", "ckpt", path=path):
        if vfy:
            _verify_archive(path)
        with fopen_read(comm, path) as r:
            doc = _read_header_sections(r)
            if doc.get("format") != mf.SHARDED_FORMAT:
                return _restore_from_reader(r, doc, like, pf, device)
        # A set's manifest holds no payloads: close it and resolve the
        # shard archives.
        from repro_torch.checkpoint import sharding as _sharding
        return _sharding.restore_sharded(path, doc, like, device=device,
                                         comm=comm,
                                         prefetch_bytes=prefetch_bytes,
                                         verify=vfy)


def _restore_from_reader(r: ScdaReader, doc: Dict[str, Any], like,
                         pf: int, device):
    """The flat restore body (the reader past the manifest); a delta
    doc's leaves resolve through its chain."""
    step = doc.get("step")
    chained = bool(doc.get("delta"))
    if chained:
        from repro_torch.checkpoint import delta as _delta
    by_name: Dict[str, Any] = {}
    for i, spec_ in enumerate(doc["leaves"]):
        by_name[spec_["name"]] = (i, spec_)

    if like is None:
        out: Dict[str, Any] = {}
        if chained:
            _adopt_sidecar(r)
            wanted = [(spec_["name"], i, spec_, None)
                      for i, spec_ in enumerate(doc["leaves"])]
            out = (_delta.restore_chained(r, doc, wanted, pf, device=device)
                   if wanted else {})
        elif pf > 0 and doc["leaves"]:
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
    if chained:
        wanted = [(name,) + by_name[name] + (targets[name],)
                  for name in targets if name in by_name]
        values = (_delta.restore_chained(r, doc, wanted, pf, device=device)
                  if wanted else {})
    elif pf > 0:
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
    vfy = _effective_verify(verify)
    with _trace.span("restore_leaf", "ckpt", path=path, leaf=name):
        if vfy:
            _verify_archive(path)
        with fopen_read(comm, path) as r:
            doc = _read_header_sections(r)
            if doc.get("format") != mf.SHARDED_FORMAT:
                return _restore_leaf_from_reader(r, doc, name, like, pf,
                                                 device)
        from repro_torch.checkpoint import sharding as _sharding
        return _sharding.restore_leaf_sharded(
            path, doc, name, like, device=device, comm=comm,
            prefetch_bytes=prefetch_bytes, verify=vfy)


def _restore_leaf_from_reader(r: ScdaReader, doc: Dict[str, Any],
                              name: str, like, pf: int, device):
    for i, spec_ in enumerate(doc["leaves"]):
        if spec_["name"] != name:
            continue
        _adopt_sidecar(r)
        if doc.get("delta"):
            from repro_torch.checkpoint import delta as _delta
            return _delta.restore_chained(
                r, doc, [(name, i, spec_, like)], pf, device=device)[name]
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


def _as_tensor(raw: np.ndarray, spec_, shape=None) -> torch.Tensor:
    """Host uint8 bytes → a CPU tensor of the manifest's dtype and shape
    (or ``shape``: a local shard's), through a ``torch.uint8`` view, so no
    numpy bf16 is needed."""
    dtype = mf.dtype_from_name(spec_["dtype"])
    shape = spec_["shape"] if shape is None else shape
    if not raw.size:  # an empty leaf (its byte view has no usable stride)
        return torch.empty(shape, dtype=dtype)
    return torch.from_numpy(raw).view(dtype).reshape(shape)


def _to_device(t: torch.Tensor, target, device) -> torch.Tensor:
    dev = _target_device(target, device)
    return t if dev.type == "cpu" else t.to(dev)


def _leaf_layout(name: str, spec_, target, device) -> Dict[str, Any]:
    """One leaf's destination: its runs in the canonical stream and a host
    buffer they fill — the whole leaf (one run), or for a DTensor target
    this rank's local shard — whichever archives its bytes come from.
    The buffer is uninitialised: the runs cover every byte of it."""
    _check_target_shape(spec_, target)
    nbytes = spec_["nbytes"]
    leaf = {"name": name, "spec": spec_, "target": target,
            "device": device, "pending": 0}
    if _is_dtensor(target):
        itemsize = mf.dtype_from_name(spec_["dtype"]).itemsize
        lshape, offset, _ = _local_block(target)
        off_mesh = target.device_mesh.get_coordinate() is None
        # zeros where nothing is read into it: a 0-d leaf off the mesh
        make = np.zeros if off_mesh else np.empty
        leaf.update(whole=False, runs=None, local_shape=lshape,
                    offset=offset, itemsize=itemsize,
                    slabs=[] if off_mesh else _block_slabs(
                        tuple(spec_["shape"]), lshape, offset, itemsize),
                    arr=make(math.prod(lshape) * itemsize, np.uint8))
    else:
        leaf.update(whole=True, runs=[(0, 0, nbytes)] if nbytes else [],
                    local_shape=None, arr=np.empty(nbytes, np.uint8))
    return leaf


def _leaf_runs(leaf: Dict[str, Any]) -> List[layout.Run]:
    """The runs a leaf's buffer takes from the canonical stream (a DTensor
    target's computed at first use: only chunk reads need them)."""
    if leaf["runs"] is None:
        leaf["runs"] = _block_runs(tuple(leaf["spec"]["shape"]),
                                   leaf["local_shape"], leaf["offset"],
                                   leaf["itemsize"])
    return leaf["runs"]


def _fill_from_slabs(leaf: Dict[str, Any], slabs, spans) -> None:
    """Copy the block's rows out of each slab's span (bytes read from the
    file)."""
    shape = tuple(leaf["spec"]["shape"])
    for (i0, i1, _, _), span in zip(slabs, spans):
        dst, src = _slab_views(leaf["arr"], np.frombuffer(span, np.uint8),
                               shape, leaf["local_shape"], leaf["itemsize"],
                               (i0, i1))
        dst[...] = src


def _finalize_leaf(leaf: Dict[str, Any]) -> torch.Tensor:
    """The filled buffer as the leaf: a tensor on its device, or a DTensor
    built from this rank's shard with the target's mesh and placements
    (``from_local`` without its check: no collective)."""
    target, device = leaf["target"], leaf["device"]
    local = _as_tensor(leaf["arr"], leaf["spec"], leaf["local_shape"])
    if leaf["whole"]:
        return _to_device(local, target, device)
    from torch.distributed.tensor import DTensor
    dev = _target_device(target, device)
    if dev.type != "cpu":
        local = local.to(dev)
    shape = tuple(target.shape)
    return DTensor.from_local(
        local, target.device_mesh, target.placements, run_check=False,
        shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


# --------------------------------------------------------------------------
# The overlapped restore engine's checkpoint scheduler
# --------------------------------------------------------------------------

def _restore_pipelined(r: ScdaReader, wanted, prefetch_bytes: int,
                       device) -> Dict[str, Any]:
    """Restore ``wanted`` leaves ``(name, manifest_index, spec, target)``
    through the overlapped engine: raw leaves read straight into their
    host buffers, compressed leaves inflate on the codec pool, all reads
    sorted by file offset and prefetched ``prefetch_bytes`` ahead.
    Byte-identical to the serial walk — only the schedule changes.  A
    DTensor target reads its local shard's slabs (:data:`SLAB_BYTES`), or
    the chunks that overlap its runs, and nothing else of the leaf."""
    idx = _resolve_index(r)
    backend = r._backend
    leaves: List[Dict[str, Any]] = []
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
        leaf = _leaf_layout(name, spec_, target, device)
        leaves.append(leaf)
        if spec_["compressed"]:
            if leaf["whole"]:
                needed = list(range(e.N)) if leaf["runs"] else []
            else:
                needed = layout.chunks_for_runs(_leaf_runs(leaf),
                                                spec_["chunk_bytes"])
            if not needed:
                continue
            csizes = r._parse_entries(e.v_entries_start, 0, e.N, b"E")
            offs = partition.offsets(csizes)
            usizes = r._parse_entries(e.entries_start, 0, e.N, b"U")
            items.append(ReadItem(
                (pos, "chunks", needed),
                [(e.v_data_start + offs[c], csizes[c]) for c in needed],
                inflate=True, expected_sizes=[usizes[c] for c in needed]))
        elif leaf["whole"]:
            if leaf["runs"]:
                items.append(ReadItem(
                    (pos, "whole", None), [(e.data_start, spec_["nbytes"])],
                    dst=[memoryview(leaf["arr"])]))
        else:
            for slab in leaf["slabs"]:
                items.append(ReadItem((pos, "slab", slab),
                                      [(e.data_start + slab[2], slab[3])]))

    items.sort(key=lambda it: it.start())
    for (pos, kind, what), res in run_pipeline(backend, items,
                                               prefetch_bytes):
        leaf = leaves[pos]
        if kind == "slab":
            _fill_from_slabs(leaf, [what], res)
        elif kind == "chunks" and leaf["whole"]:
            _fill_joined(res, leaf["arr"], leaf["spec"])
        elif kind == "chunks":
            _scatter_chunks_np(_leaf_runs(leaf), dict(zip(what, res)),
                               leaf["spec"]["chunk_bytes"], leaf["arr"])
    return {leaf["name"]: _finalize_leaf(leaf) for leaf in leaves}


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


def _short_chunk(ci: int, have: int, want: int) -> ScdaError:
    return ScdaError(
        ScdaErrorCode.CORRUPT_CHECKSUM,
        f"chunk {ci} holds {have} bytes, layout needs {want} — inflated "
        f"size disagrees with the manifest chunk geometry")


def _scatter_chunks_np(runs, chunks: Dict[int, bytes], chunk_bytes: int,
                       arr: np.ndarray) -> None:
    """Copy the spans of inflated ``chunks`` that ``runs`` cover into
    ``arr``; a chunk shorter than the manifest's geometry implies is
    CORRUPT_CHECKSUM, never a short copy."""
    for goff, loff, n in runs:
        pos = 0
        while pos < n:
            ci, off = divmod(goff + pos, chunk_bytes)
            take = min(n - pos, chunk_bytes - off)
            data = chunks[ci]
            if len(data) < off + take:
                raise _short_chunk(ci, len(data), off + take)
            arr[loff + pos:loff + pos + take] = \
                np.frombuffer(data, np.uint8, take, off)
            pos += take


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
    """The serial read of one leaf onto its target: the whole leaf, or a
    DTensor target's local shard from its slabs (a compressed leaf's
    chunks that overlap its runs only)."""
    if not _is_dtensor(target):
        _check_target_shape(spec_, target)
        return _to_device(_read_leaf_full(r, spec_), target, device)
    leaf = _leaf_layout(spec_["name"], spec_, target, device)
    if spec_["compressed"]:
        cb, runs = spec_["chunk_bytes"], _leaf_runs(leaf)
        needed = layout.chunks_for_runs(runs, cb)
        if needed:
            _scatter_chunks_np(
                runs, dict(zip(needed, r.read_varray_elements(needed))), cb,
                leaf["arr"])
    elif leaf["slabs"]:
        _fill_from_slabs(leaf, leaf["slabs"], r.read_array_windows(
            [(start, n) for _, _, start, n in leaf["slabs"]], 1))
    r.skip_data()
    return _finalize_leaf(leaf)


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
