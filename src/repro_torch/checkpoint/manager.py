"""Checkpoint lifecycle management for long-running training jobs — the
flat-save subset of ``repro/checkpoint/manager.py``.

The reference's properties, on torch state:

  * **Async**: the only synchronous work is the device→host snapshot;
    serialization and disk I/O run on a background thread.
  * **Atomic**: writes go to ``<name>.tmp`` and are fsync'd before an
    atomic rename and a directory fsync; ``latest_step`` only ever sees
    complete files.
  * **Non-fatal**: an error in a background save is recorded and raised
    by the *next* call (or ``wait()``).
  * **Retention**: the newest ``keep`` checkpoints stay (always ≥ 1), so a
    corrupted newest file can fall back to an older one.
  * **Journaled**: :meth:`CheckpointManager.journal` buffers telemetry
    and flushes it into the newest committed file after every commit.

A file written here (with ``vendor=REFERENCE_VENDOR``) is the one the JAX
package's manager writes for the same arrays, and each package restores
the other's directories.  Delta, sharded and parity saves are not ported:
asking for them (by argument or by the reference's environment knobs)
raises :class:`NotImplementedError`.

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

from repro_torch.checkpoint import pytree_io
from repro_torch.core import ScdaError
from repro_torch.core import trace as _trace
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

#: The reference's knobs for the layouts this port does not carry.
DELTA_ENV = "REPRO_SCDA_DELTA"


def _ckpt_name(step: int) -> str:
    return f"step_{step:010d}.scda"


def _env_on(name: str) -> bool:
    return os.environ.get(name, "0") not in ("0", "", "no")


def snapshot_to_host(tree, pinned: Optional[Dict[str, torch.Tensor]] = None):
    """A host copy of every tensor leaf of ``tree`` (same structure, shape
    and dtype), which later in-place updates of the tree do not reach.

    CUDA leaves are copied into pinned host buffers: ``pinned`` maps leaf
    names to buffers kept from an earlier snapshot and gains the ones
    allocated here (a buffer is reused when shape and dtype still match).
    The copies are asynchronous and synchronised before the return.  CPU
    leaves are cloned; anything else is passed through.
    """
    pinned = {} if pinned is None else pinned
    named, rebuild = pytree_io.flatten_named(tree)
    out, cuda = [], False
    for name, x in named:
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.device.type == "cuda":
                buf = pinned.get(name)
                if buf is None or buf.shape != x.shape \
                        or buf.dtype != x.dtype:
                    buf = torch.empty(x.shape, dtype=x.dtype,
                                      pin_memory=True)
                    pinned[name] = buf
                buf.copy_(x, non_blocking=True)
                x, cuda = buf, True
            else:
                x = x.clone()
        out.append(x)
    if cuda:
        torch.cuda.synchronize()
    return rebuild(out)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 compressed: bool = False,
                 delta: Optional[bool] = None,
                 shards: Optional[int] = None,
                 parity: Optional[int] = None,
                 vendor: bytes = pytree_io.DEFAULT_VENDOR) -> None:
        use_delta = _env_on(DELTA_ENV) if delta is None else bool(delta)
        if use_delta or shards or parity:
            raise NotImplementedError(
                f"delta, sharded and parity checkpoints are not ported yet "
                f"(delta={use_delta}, shards={shards}, parity={parity})")
        self.directory = directory
        self.keep = max(1, keep)
        self.compressed = compressed
        self.vendor = vendor
        self._pinned: Dict[str, torch.Tensor] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._journal = None  # lazy ScdaJournal (see journal())
        self._lock_path = os.path.join(directory, LOCK_NAME)
        self._lock_owned = False
        os.makedirs(directory, exist_ok=True)
        self._acquire_lock()

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
        ``.item()`` on a tensor first."""
        if self._journal is None:
            from repro_torch.journal import ScdaJournal
            latest = self.latest_step()
            self._journal = ScdaJournal(
                self.path_for(latest) if latest is not None else None)
        return self._journal

    # -- saving ----------------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = False,
             aux_extra: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot now; serialize and write in the background.

        Raises any error from the *previous* async save (so failures are
        observed, but off the hot path).
        """
        self.wait()  # one in-flight save at a time; surfaces prior errors
        with _trace.span("snapshot", "ckpt", step=step):
            host_tree = snapshot_to_host(tree, self._pinned)

        def _write() -> None:
            try:
                self._write_and_commit(step, host_tree, aux_extra)
            except BaseException as e:  # noqa: BLE001 - stored, not raised
                self._error = e

        if blocking:
            _write()
            self._raise_pending()
        else:
            self._thread = threading.Thread(target=_write, daemon=True,
                                            name=f"ckpt-save-{step}")
            self._thread.start()

    def _write_and_commit(self, step: int, host_tree,
                          aux_extra: Optional[Dict[str, Any]]) -> None:
        final = self.path_for(step)
        tmp = final + ".tmp"
        try:
            pytree_io.save(tmp, host_tree, step=step,
                           compressed=self.compressed, aux_extra=aux_extra,
                           vendor=self.vendor)
        except BaseException:
            # A failed save must not leave its half-written tmp around.
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        with _trace.span("commit", "ckpt", path=final, step=step):
            # Atomic commit: rename + parent-dir fsync.
            replace_durable(tmp, final)
            # Best-effort: readers fall back to a header scan.
            ScdaIndex.write_sidecars([final])
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

    def _apply_retention(self) -> None:
        """Drop all but the newest ``keep`` checkpoints (and their
        sidecars), then stale tmp files and orphaned sidecars."""
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            p = self.path_for(s)
            for path in (p, p + SIDECAR_SUFFIX):
                try:
                    os.remove(path)
                except OSError:
                    pass  # retention is best-effort
        kept = {_ckpt_name(s) for s in self.all_steps()}
        for n in os.listdir(self.directory):
            stale = (n.endswith(".scda.tmp") or n.endswith(".scdax.tmp")
                     or (n.endswith(".scda" + SIDECAR_SUFFIX)
                         and n[:-len(SIDECAR_SUFFIX)] not in kept))
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
