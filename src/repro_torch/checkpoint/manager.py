"""Checkpoint lifecycle management for long-running training jobs — the
port of ``repro/checkpoint/manager.py``.

The reference's properties, on torch state:

  * **Async**: the only synchronous work is the device→host snapshot;
    serialization and disk I/O run on a background thread.
  * **Atomic**: writes go to ``<name>.tmp`` and are fsync'd before an
    atomic rename and a directory fsync; ``latest_step`` only ever sees
    complete files.
  * **Non-fatal**: an error in a background save is recorded and raised
    by the *next* call (or ``wait()``).
  * **Retention**: the newest ``keep`` checkpoints stay (always ≥ 1), so a
    corrupted newest file can fall back to an older one.  Retention is
    chain-aware (a base a kept delta references stays) and drops a set's
    shards and parity with its manifest.
  * **Incremental**: with ``delta=True`` (or ``REPRO_SCDA_DELTA=1``) a
    save stores only the chunks that changed since the newest committed
    checkpoint, up to ``delta_chain`` (``REPRO_SCDA_DELTA_CHAIN``) saves
    in a chain before a full one.
  * **Sharded and parity-protected**: ``shards=N`` (``REPRO_SCDA_SHARDS``)
    writes each checkpoint as N archives and a manifest, committed
    manifest last; ``parity=m`` (``REPRO_SCDA_PARITY``) adds m erasure-code
    shards, so a set that lost up to m files restores through the
    survivors.
  * **Journaled**: :meth:`CheckpointManager.journal` buffers telemetry
    and flushes it into the newest committed file after every commit.

A file written here (with ``vendor=REFERENCE_VENDOR``) is the one the JAX
package's manager writes for the same arrays, and each package restores
the other's directories.

**Ranked**: with ``comm`` a communicator of several ranks, every rank
calls ``save``; each passes its snapshot and the comm to the save, and
once all have written, rank 0 commits, writes the sidecars, flushes the
journal and prunes.  Only rank 0 holds the directory's lock, and only its
journal buffers.  Compression and deltas are single-rank, as
``pytree_io.save`` has them: such a save raises ``ScdaError``.  With a
``TorchDistComm`` the state is DTensors: each rank snapshots the blocks it
owns (pinned host buffers, as below), and the writer's collectives run on
a process group of the manager's own (``dist.new_group``), so they never
interleave with the step's.

The snapshot is a copy.  The port updates its training state in place, so
``save`` must not hand the writer views of live tensors: CUDA tensors are
copied into pinned host buffers that are kept and reused by later saves
(a full-width training state is 20 GB, too much to pin afresh each time),
with a synchronisation before ``save`` returns; CPU tensors are cloned.
"""
from __future__ import annotations

import json
import os
import re
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import delta as _delta
from repro_torch.checkpoint import manifest as _mf
from repro_torch.checkpoint import pytree_io
from repro_torch.checkpoint import redundancy as _red
from repro_torch.checkpoint import sharding as _sharding
from repro_torch.core import ScdaError
from repro_torch.core import trace as _trace
from repro_torch.core.comm import Communicator, SerialComm, TorchDistComm
from repro_torch.core.errors import ScdaErrorCode
from repro_torch.core.index import SIDECAR_SUFFIX, ScdaIndex
from repro_torch.core.io_backend import replace_durable

_CKPT_RE = re.compile(r"^step_(\d{10})\.scda$")

#: Advisory writer lock: O_EXCL-created in the checkpoint directory so
#: two managers on one directory refuse instead of interleaving commits.
LOCK_NAME = ".scda-lock"

#: A foreign-host lock older than this is presumed dead (we cannot
#: signal-probe across hosts); same-host locks are probed by pid.
LOCK_TTL_SECONDS = 3600.0


def _ckpt_name(step: int) -> str:
    return f"step_{step:010d}.scda"


def snapshot_to_host(tree, pinned: Optional[Dict[str, torch.Tensor]] = None,
                     *, ranked: bool = False):
    """A host copy of every tensor leaf of ``tree`` (same structure, shape
    and dtype), which later in-place updates of the tree do not reach.

    CUDA leaves are copied into pinned host buffers: ``pinned`` maps leaf
    names to buffers kept from an earlier snapshot and gains the ones
    allocated here (a buffer is reused when shape and dtype still match).
    The copies are asynchronous and synchronised before the return.  CPU
    leaves are cloned; anything else is passed through.

    Single-process (``ranked=False``), a DTensor leaf raises, naming the
    leaf, and is never gathered.  ``ranked=True`` (a manager with a
    ``comm`` of several ranks): a DTensor leaf becomes a DTensor of the
    same mesh, placements and shape whose local tensor is the host copy
    of this rank's block where it owns that block for a save, and an
    empty ``meta`` tensor where another rank writes it.
    """
    pinned = {} if pinned is None else pinned
    named, rebuild = pytree_io.flatten_named(tree)
    out, cuda = [], False
    for name, x in named:
        if ranked and pytree_io._is_dtensor(x):
            from torch.distributed.tensor import DTensor
            local = x.to_local().detach()
            if pytree_io._local_block(x)[2]:
                local, on_card = _host_copy(local, name, pinned)
                cuda = cuda or on_card
            else:
                local = torch.empty(local.shape, dtype=local.dtype,
                                    device="meta")
            out.append(DTensor.from_local(
                local, x.device_mesh, x.placements, run_check=False,
                shape=x.shape, stride=x.stride()))
            continue
        if pytree_io._is_dtensor(x):
            raise ScdaError(
                ScdaErrorCode.ARG_SEQUENCE,
                f"leaf {name}: a DTensor; the CheckpointManager is "
                f"single-process — save DTensor state with "
                f"pytree_io.save(..., comm=TorchDistComm()) on every rank")
        if isinstance(x, torch.Tensor):
            x, on_card = _host_copy(x.detach(), name, pinned)
            cuda = cuda or on_card
        out.append(x)
    if cuda:
        torch.cuda.synchronize()
    return rebuild(out)


def _host_copy(x: torch.Tensor, name: str, pinned):
    """``(copy, from_card)``: a CUDA tensor's asynchronous copy into the
    pinned buffer ``pinned[name]`` (made or remade to fit), a CPU
    tensor's clone."""
    if x.device.type != "cuda":
        return x.clone(), False
    buf = pinned.get(name)
    if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        pinned[name] = buf
    buf.copy_(x, non_blocking=True)
    return buf, True


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 compressed: bool = False,
                 chunk_bytes: int = pytree_io.DEFAULT_CHUNK_BYTES,
                 delta: Optional[bool] = None,
                 delta_chain: Optional[int] = None,
                 shards: Optional[int] = None,
                 parity: Optional[int] = None,
                 vendor: bytes = pytree_io.DEFAULT_VENDOR,
                 comm: Optional[Communicator] = None,
                 index_sidecar: bool = True) -> None:
        self.directory = directory
        self.comm = comm or SerialComm()
        # DTensor ranks: snapshots keep each rank's own blocks.
        self._dtensor_ranks = (isinstance(self.comm, TorchDistComm)
                               and self.comm.size > 1)
        if self._dtensor_ranks:
            import torch.distributed as dist
            ranks = [self.comm._global(r) for r in range(self.comm.size)]
            self.comm = TorchDistComm(dist.new_group(ranks,
                                                     backend="gloo"))
        self.keep = max(1, keep)
        self.compressed = compressed
        self.chunk_bytes = chunk_bytes
        self.vendor = vendor
        # Sidecars (.scdax) let restore_leaf seek without a header scan.
        self.index_sidecar = index_sidecar
        # None defers each to its knob; parity without sharding has
        # nothing to code over, so it collapses to 0 for flat saves.
        self.shards = (_sharding.shards_default()
                       if shards is None else max(0, int(shards)))
        self.parity = (_red.parity_default()
                       if parity is None else max(0, int(parity)))
        if not self.shards:
            self.parity = 0
        _red.check_geometry(self.shards, self.parity)
        # The chain depth cap forces a periodic full save, so restore
        # fan-in stays bounded and retention can drop old bases.
        self.delta = (_delta.delta_enabled_default()
                      if delta is None else bool(delta))
        self.delta_chain = (_delta.chain_limit()
                            if delta_chain is None else max(1, delta_chain))
        self._last_doc: Optional[Tuple[Dict[str, Any], str]] = None
        self._pinned: Dict[str, torch.Tensor] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._journal = None  # lazy ScdaJournal (see journal())
        self._lock_path = os.path.join(directory, LOCK_NAME)
        self._lock_owned = False
        if self.comm.rank == 0:
            os.makedirs(directory, exist_ok=True)
            self._acquire_lock()
        self.comm.barrier()   # the directory exists, rank 0 holds it

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def close(self) -> None:
        """Join any in-flight save and release the writer lock."""
        try:
            self.wait()
        finally:
            if self._lock_owned:
                try:
                    os.remove(self._lock_path)
                except OSError:
                    pass
                self._lock_owned = False

    # -- advisory writer lock ------------------------------------------------
    def _acquire_lock(self) -> None:
        """O_EXCL lockfile (pid/host/timestamp) in the checkpoint dir.

        A live holder refuses loudly; a stale holder (dead pid on this
        host, or a foreign-host lock past LOCK_TTL_SECONDS) is taken over
        with a loud warning.  A lock held by THIS process is shared.
        """
        me = {"pid": os.getpid(), "host": socket.gethostname(),
              "time": time.time()}
        for _ in range(16):  # bounded takeover races
            try:
                fd = os.open(self._lock_path,
                             os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
            except FileExistsError:
                pass
            else:
                with os.fdopen(fd, "w") as f:
                    f.write(json.dumps(me))
                self._lock_owned = True
                return
            try:
                with open(self._lock_path, "r") as f:
                    cur = json.loads(f.read() or "{}")
            except (OSError, ValueError):
                cur = {}
            if not isinstance(cur, dict):
                cur = {}
            if cur.get("host") == me["host"] \
                    and cur.get("pid") == me["pid"]:
                return  # same process — shared advisory lock
            if not cur:
                stale = True  # unreadable/empty lock: crashed mid-write
            elif cur.get("host") == me["host"] \
                    and isinstance(cur.get("pid"), int):
                try:
                    os.kill(cur["pid"], 0)
                    stale = False
                except OSError:
                    stale = True  # holder process is gone
            else:
                try:
                    age = time.time() - float(cur.get("time", 0))
                except (TypeError, ValueError):
                    age = LOCK_TTL_SECONDS + 1
                stale = age > LOCK_TTL_SECONDS
            if not stale:
                raise ScdaError(
                    ScdaErrorCode.FS_OPEN,
                    f"checkpoint directory {self.directory!r} is locked "
                    f"by pid {cur.get('pid')} on {cur.get('host')!r} "
                    f"(since {cur.get('time')}); remove "
                    f"{self._lock_path!r} if that writer is gone")
            _trace.warn(
                f"repro: TAKING OVER stale checkpoint lock "
                f"{self._lock_path!r} (holder pid {cur.get('pid')} on "
                f"{cur.get('host')!r} presumed dead)",
                key=("lock-takeover", self._lock_path))
            try:
                os.remove(self._lock_path)
            except OSError:
                pass  # lost a takeover race; retry the O_EXCL create
        raise ScdaError(
            ScdaErrorCode.FS_OPEN,
            f"could not acquire checkpoint lock {self._lock_path!r}")

    # -- inventory -----------------------------------------------------------
    def all_steps(self) -> List[int]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        steps = [int(m.group(1)) for n in names
                 if (m := _CKPT_RE.match(n))]
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path_for(self, step: int) -> str:
        return os.path.join(self.directory, _ckpt_name(step))

    # -- journaling ----------------------------------------------------------
    def journal(self):
        """The run's telemetry journal (:class:`repro_torch.journal.
        ScdaJournal`): ``journal().log(step, scalars)`` buffers records,
        which go into the newest *committed* checkpoint file right after
        every commit (flush-on-commit).  Scalars must be host values: call
        ``.item()`` on a tensor first.  Only rank 0's journal buffers;
        elsewhere ``log`` does nothing, so replicated code may log on
        every rank."""
        if self._journal is None:
            from repro_torch.journal import ScdaJournal
            latest = self.latest_step()
            self._journal = ScdaJournal(
                self.path_for(latest) if latest is not None else None,
                enabled=self.comm.rank == 0)
        return self._journal

    # -- saving ----------------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = False,
             aux_extra: Optional[Dict[str, Any]] = None,
             delta: Optional[bool] = None) -> None:
        """Snapshot now; serialize and write in the background.

        ``delta=True`` saves incrementally against the newest committed
        checkpoint (``None``: the manager's default); it falls back to a
        full save when no usable base exists or the chain cap is reached.
        Raises any error from the *previous* async save (so failures are
        observed, but off the hot path).
        """
        self.wait()  # one in-flight save at a time; surfaces prior errors
        with _trace.span("snapshot", "ckpt", step=step):
            host_tree = (snapshot_to_host(tree, self._pinned, ranked=True)
                         if self._dtensor_ranks else
                         snapshot_to_host(tree, self._pinned))
        use_delta = self.delta if delta is None else bool(delta)

        def _write() -> None:
            try:
                self._write_and_commit(step, host_tree, aux_extra,
                                       use_delta)
            except BaseException as e:  # noqa: BLE001 - stored, not raised
                self._error = e

        if blocking:
            _write()
            self._raise_pending()
        else:
            self._thread = threading.Thread(target=_write, daemon=True,
                                            name=f"ckpt-save-{step}")
            self._thread.start()

    def _delta_base(self, step: int) \
            -> Optional[Tuple[Dict[str, Any], str]]:
        """The ``(manifest_doc, file_name)`` the next delta references, or
        ``None`` for a full save: no prior checkpoint, one without chunk
        digests, a re-save of ``step`` itself, a newest set that cannot
        be opened whole, or the chain cap reached."""
        target = _ckpt_name(step)
        cand: Optional[Tuple[Dict[str, Any], str]] = None
        if self._last_doc is not None and self._last_doc[1] != target:
            cand = self._last_doc
        else:
            for s in reversed(self.all_steps()):
                name = _ckpt_name(s)
                if name == target:
                    continue  # never self-reference on a same-step re-save
                try:
                    doc = pytree_io.read_manifest(self.path_for(s))
                    if doc.get("format") == _mf.SHARDED_FORMAT:
                        # A set's digest tables are in its shards' docs,
                        # each content-id-verified: a set with a lost or
                        # rewritten shard falls back to a full save.
                        doc = _sharding.load_set(self.path_for(s))
                except (ScdaError, OSError, ValueError):
                    continue  # unreadable base: fall further back
                cand = (doc, name)
                break
        if cand is None or not _sharding.base_usable_any(cand[0]):
            return None
        if _sharding.chain_depth(cand[0]) + 1 > self.delta_chain:
            return None
        return cand

    def _write_and_commit(self, step: int, host_tree,
                          aux_extra: Optional[Dict[str, Any]],
                          use_delta: bool = False) -> None:
        """Every rank writes its part of ``<name>.tmp`` (a set's files
        each with ``.tmp``); once all have, rank 0 commits, flushes the
        journal and prunes, and the ranks meet again, so a later restore
        on any rank sees the commit."""
        final = self.path_for(step)
        tmp = final + ".tmp"
        comm = self.comm
        with _trace.span("plan", "ckpt", step=step, delta=use_delta,
                         shards=self.shards, parity=self.parity):
            base = self._delta_base(step) if use_delta else None
        try:
            if self.shards:
                # Every file of the set is written as <name>.tmp while the
                # manifest records the final names; commit_sharded renames
                # shards and parity first and the manifest last.
                doc = _sharding.save_sharded(
                    final, host_tree, shards=self.shards, comm=comm,
                    step=step, compressed=self.compressed,
                    chunk_bytes=self.chunk_bytes, aux_extra=aux_extra,
                    record_hashes=use_delta or self.delta,
                    delta_base=base, parity=self.parity,
                    tmp_suffix=".tmp", vendor=self.vendor)
            else:
                doc = pytree_io.save(tmp, host_tree, comm=comm, step=step,
                                     compressed=self.compressed,
                                     chunk_bytes=self.chunk_bytes,
                                     aux_extra=aux_extra,
                                     vendor=self.vendor,
                                     record_hashes=use_delta or self.delta,
                                     delta_base=base, shards=0)
        except BaseException:
            # A failed save must not leave its half-written files around.
            if comm.rank == 0:
                stale = (_sharding.set_paths(final, self.shards, ".tmp",
                                             parity=self.parity)
                         if self.shards else [tmp])
                for p in stale:
                    try:
                        os.remove(p)
                    except OSError:
                        pass
            raise
        comm.barrier()
        if comm.rank == 0:
            self._commit(step, final, tmp, doc)
        # The doc a re-read of the fresh checkpoint would parse: the next
        # delta references it without touching the disk.
        self._last_doc = (doc, _ckpt_name(step))
        comm.barrier()

    def _commit(self, step: int, final: str, tmp: str,
                doc: Dict[str, Any]) -> None:
        """Rank 0's part of a save: rename into place, sidecars, journal,
        retention."""
        with _trace.span("commit", "ckpt", path=final, step=step):
            if self.shards:
                _sharding.commit_sharded(final, doc, ".tmp")
                committed = [os.path.join(self.directory, s["file"])
                             for s in doc["shards"]]
                committed += [os.path.join(self.directory, p["file"])
                              for p in (doc.get("parity") or {})
                              .get("files", [])]
                committed.append(final)
            else:
                # Atomic commit: rename + parent-dir fsync.
                replace_durable(tmp, final)
                committed = [final]
            if self.index_sidecar:
                # Best-effort: readers fall back to a header scan.
                ScdaIndex.write_sidecars(committed)
        c = _trace.collector()
        if c is not None:
            # The I/O counters since the last commit ride into the
            # checkpoint's own journal.
            rec = c.commit_record()
            if rec:
                self.journal().log(step, {"trace": rec})
        if self._journal is not None:
            # Flush-on-commit; a failed flush keeps the records buffered
            # for the next commit.
            self._journal.retarget(final)
            try:
                self._journal.flush()
            except (ScdaError, OSError):
                pass
        with _trace.span("retention", "ckpt", keep=self.keep):
            self._apply_retention()

    def _shard_files(self, name: str) -> List[str]:
        """Shard and parity file names of checkpoint ``name`` (empty for
        a flat archive or anything unreadable): retention treats a set
        as one unit."""
        try:
            doc = pytree_io.read_manifest(
                os.path.join(self.directory, name))
        except (ScdaError, OSError, ValueError):
            return []
        if doc.get("format") != _mf.SHARDED_FORMAT:
            return []
        return [s.get("file") for s in doc.get("shards", [])
                if s.get("file")] \
            + [p.get("file")
               for p in (doc.get("parity") or {}).get("files", [])
               if p.get("file")]

    def _referenced_files(self, kept_steps: List[int]) -> set:
        """The delta-base files the kept checkpoints still reference,
        transitively.  A set's manifest is traversed through its shards
        (whose docs hold the references), so protection lands on shard
        file names and the sweep keeps their whole set."""
        protected: set = set()
        queue = [_ckpt_name(s) for s in kept_steps]
        seen = set(queue)
        while queue:
            name = queue.pop()
            try:
                doc = pytree_io.read_manifest(
                    os.path.join(self.directory, name))
            except (ScdaError, OSError, ValueError):
                continue  # unreadable: nothing to protect through it
            if doc.get("format") == _mf.SHARDED_FORMAT:
                for s in doc.get("shards", []):
                    f = s.get("file")
                    if f and f not in seen:
                        seen.add(f)
                        queue.append(f)  # traverse, don't protect
                continue
            for b in (doc.get("delta") or {}).get("bases", []):
                f = b.get("file")
                if f and f not in seen:
                    seen.add(f)
                    protected.add(f)
                    queue.append(f)
        return protected

    def _apply_retention(self) -> None:
        """Drop all but the newest ``keep`` checkpoints (each with its
        shards, parity and sidecars) unless a kept delta references one,
        then stale tmp files, orphaned sidecars and shard or parity files
        whose manifest is gone."""
        steps = self.all_steps()
        protected = self._referenced_files(steps[-self.keep:])
        for s in steps[:-self.keep]:
            files = [_ckpt_name(s)] + self._shard_files(_ckpt_name(s))
            if any(f in protected for f in files):
                continue  # a kept delta chain still needs this base
            for f in files:
                p = os.path.join(self.directory, f)
                for path in (p, p + SIDECAR_SUFFIX):
                    try:
                        os.remove(path)
                    except OSError:
                        pass  # retention is best-effort
        keep_names = set(protected)
        for s in self.all_steps():
            n = _ckpt_name(s)
            keep_names.add(n)
            keep_names.update(self._shard_files(n))
        for n in os.listdir(self.directory):
            stale = (n.endswith(".scda.tmp") or n.endswith(".scdax.tmp")
                     or (n.endswith(".scda" + SIDECAR_SUFFIX)
                         and n[:-len(SIDECAR_SUFFIX)] not in keep_names)
                     or (_sharding.is_shard_name(n) is not None
                         and n not in keep_names)
                     or (_red.is_parity_name(n) is not None
                         and n not in keep_names))
            if stale:
                try:
                    os.remove(os.path.join(self.directory, n))
                except OSError:
                    pass

    def wait(self) -> None:
        """Join any in-flight save and surface its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restoring ---------------------------------------------------------------
    def restore(self, step: int, like=None, *, device=None) \
            -> Tuple[Any, Optional[int]]:
        """Checkpoint ``step`` as ``like``'s structure (NamedTuples
        included), each leaf on ``device`` or on its ``like`` leaf's."""
        return pytree_io.restore(self.path_for(step), like, device=device)

    def restore_leaf(self, step: int, name: str, like=None, *, device=None):
        """Lazily load one tensor of checkpoint ``step`` (index seek)."""
        return pytree_io.restore_leaf(self.path_for(step), name, like,
                                      device=device)

    def restore_latest(self, like=None, *, device=None) \
            -> Tuple[Any, Optional[int]]:
        """Restore the newest complete checkpoint; fall back on corruption
        to the older retained ones, in order."""
        last_err: Optional[BaseException] = None
        for step in reversed(self.all_steps()):
            try:
                return self.restore(step, like, device=device)
            except ScdaError as e:
                last_err = e
        if last_err is not None:
            raise last_err
        return None, None

    def restore_or_init(self, init_fn, like=None, *, device=None):
        """The standard restart entry point: resume if possible, else
        ``init_fn()``.  ``like`` (meta tensors will do) gives the state's
        structure, so nothing is built when a checkpoint exists.  Returns
        ``(tree, step)`` where step is -1 for a fresh start."""
        steps = self.all_steps()
        if steps:
            tree, step = self.restore_latest(like, device=device)
            if tree is not None:
                return tree, (step if step is not None else steps[-1])
        return init_fn(), -1
