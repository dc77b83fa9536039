"""Deterministic fault injection + syscall recording for the I/O stack.

The paper's §A.6 mandate — "file errors should never crash the
simulation" — is only worth anything if the error paths actually run.
This module is the single choke point every mutating syscall of the scda
stack flows through (:class:`~repro.core.io_backend.FileBackend` routes
``pwrite``/``pwritev``/``pread``/``preadv``/``fsync``/``ftruncate``
here; the checkpoint commit/rename helpers route ``replace`` and
directory fsync), which buys two capabilities for free everywhere at
once:

* **Deterministic fault injection.**  A :class:`FaultPlan` describes
  errno faults (EIO/ENOSPC/EINTR/EAGAIN), short and zero-progress
  ``pwritev``/``preadv`` completions, torn multi-fragment writes cut at
  a chosen fragment boundary, and hard crash-points at the Nth matching
  syscall (:class:`SimulatedCrash` — a ``BaseException``, so it rips
  through the taxonomy exactly like power loss would).  Scheduling is
  fully deterministic: per-rule call counters (``nth``/``count``) or a
  seeded Bernoulli stream (``p``/``seed``), never wall clock.  Plans
  activate three ways:

  - process-wide from the environment: ``REPRO_SCDA_FAULTS=<spec>``
    (works under ``scdatool`` and examples, no code changes);
  - process-wide from tests: :func:`install` / :func:`inject`;
  - scoped to ONE file: :func:`FaultBackend` — a ``FileBackend`` whose
    own calls (background writeback/prefetch jobs included, since those
    re-enter the backend's methods) see a private plan.

* **Op-log recording** (:func:`record`): every successful write, fsync,
  truncate, rename, and directory fsync is appended to an :class:`OpLog`
  with its actual bytes — the raw material for power-cut replay
  (``tests/helpers/crashsim.py``), which re-materializes every crash
  prefix of a commit with un-fsynced effects dropped or torn.

Spec grammar (``REPRO_SCDA_FAULTS`` and everything above)::

    spec  := rule (';' rule)*
    rule  := op (':' field)*
    op    := pwrite | pwritev | pread | preadv | fsync | fsync_dir
           | truncate | replace | open | '*'          (any op)
    field := errno=<name|int>      raise OSError(errno) instead
           | short=<K>             complete only K bytes (write or read)
           | zero                  zero-progress completion (reads: EOF)
           | torn=<F>              pwritev: land fragments [0,F), then crash
           | crash                 SimulatedCrash instead of the op
           | missing               the call sees ENOENT (file "lost")
           | unlink                really unlink the file, then proceed
           | nth=<N>               fire on the Nth matching call (default 1)
           | count=<K>             keep firing for K calls (-1 = forever)
           | p=<float> seed=<S>    seeded per-call Bernoulli instead of nth
           | path=<substr>         only calls whose path contains substr

    REPRO_SCDA_FAULTS="pwritev:errno=ENOSPC:nth=3:path=step_"
    REPRO_SCDA_FAULTS="*:crash:nth=40;preadv:short=100:nth=2"

Exactly one action per rule; the first rule that fires wins.  No faults
configured means near-zero overhead: one ``is None`` check per syscall.
"""
from __future__ import annotations

import dataclasses
import errno as _errno
import os
import random
import threading
from typing import Callable, List, Optional, Sequence

from repro_torch.core import trace as _trace

__all__ = [
    "SimulatedCrash", "FaultRule", "FaultPlan", "FaultInjector",
    "FaultBackend", "OpLog", "Op", "install", "uninstall", "inject",
    "record", "active",
]

#: Every op name a rule may target (also the recorder's vocabulary).
OPS = ("open", "pwrite", "pwritev", "pread", "preadv", "fsync",
       "fsync_dir", "truncate", "replace")


class SimulatedCrash(BaseException):
    """An injected hard crash-point (simulated power cut / SIGKILL).

    Deliberately a ``BaseException``: nothing in the scda error taxonomy
    may catch and convert it — it must rip through ``save()`` exactly
    like the process dying would, leaving whatever bytes the prior
    syscalls landed.
    """

    def __init__(self, op: str, path: str, detail: str = ""):
        self.op = op
        self.path = path
        super().__init__(
            f"simulated crash at {op} on {path!r}"
            + (f": {detail}" if detail else ""))


_ACTIONS = ("errno", "short", "zero", "torn", "crash", "missing", "unlink")


@dataclasses.dataclass
class FaultRule:
    """One parsed rule of a fault plan (see the module spec grammar)."""
    op: str                        # an OPS name or "*"
    kind: str                      # one of _ACTIONS
    errno_: int = 0                # for kind == "errno"
    n: int = 0                     # short byte count / torn fragment index
    nth: int = 1                   # 1-based first matching call that fires
    count: int = 1                 # consecutive firings (-1 = forever)
    p: float = 0.0                 # Bernoulli rate (overrides nth/count)
    seed: int = 0                  # Bernoulli stream seed
    path: str = ""                 # substring filter on the target path
    # runtime state (not part of the parsed spec)
    _seen: int = 0
    _rng: Optional[random.Random] = None

    def matches(self, op: str, path: str) -> bool:
        return (self.op in ("*", op)) and (not self.path
                                           or self.path in path)

    def fires(self) -> bool:
        """Count this matching call; True if the rule injects on it."""
        self._seen += 1
        if self.p > 0.0:
            if self._rng is None:
                self._rng = random.Random(self.seed)
            return self._rng.random() < self.p
        if self._seen < self.nth:
            return False
        return self.count < 0 or self._seen < self.nth + self.count


def _parse_errno(value: str) -> int:
    if value.isdigit():
        return int(value)
    code = getattr(_errno, value.upper(), None)
    if not isinstance(code, int):
        raise ValueError(f"unknown errno name {value!r}")
    return code


class FaultPlan:
    """An ordered list of :class:`FaultRule` parsed from a spec string."""

    def __init__(self, rules: Sequence[FaultRule]):
        self.rules = list(rules)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        rules: List[FaultRule] = []
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            fields = raw.split(":")
            op = fields[0].strip()
            if op not in OPS and op != "*":
                raise ValueError(f"fault rule {raw!r}: unknown op {op!r}")
            kw: dict = {}
            for f in fields[1:]:
                key, _, val = f.strip().partition("=")
                if key == "errno":
                    kw["kind"], kw["errno_"] = "errno", _parse_errno(val)
                elif key in ("short", "torn"):
                    kw["kind"], kw["n"] = key, int(val)
                elif key in ("zero", "crash", "missing", "unlink"):
                    kw["kind"] = key
                elif key == "nth":
                    kw["nth"] = max(1, int(val))
                elif key == "count":
                    kw["count"] = int(val)
                elif key == "p":
                    kw["p"] = float(val)
                elif key == "seed":
                    kw["seed"] = int(val)
                elif key == "path":
                    kw["path"] = val
                else:
                    raise ValueError(f"fault rule {raw!r}: "
                                     f"unknown field {f!r}")
            if kw.get("kind") not in _ACTIONS:
                raise ValueError(f"fault rule {raw!r}: no action "
                                 f"(one of {', '.join(_ACTIONS)})")
            rules.append(FaultRule(op=op, **kw))
        return cls(rules)


class FaultInjector:
    """Stateful evaluator of a :class:`FaultPlan` (thread-safe counters)."""

    def __init__(self, plan):
        if isinstance(plan, str):
            plan = FaultPlan.parse(plan)
        self.plan = plan
        self._lock = threading.Lock()
        #: every injected fault, for test assertions: (op, path, kind)
        self.injected: List[tuple] = []

    def decide(self, op: str, path: str) -> Optional[FaultRule]:
        """The first rule firing on this call, or None (counts the call
        against every matching rule either way — deterministic across
        rule order)."""
        with self._lock:
            hit = None
            for r in self.plan.rules:
                if r.matches(op, path) and r.fires() and hit is None:
                    hit = r
            if hit is not None:
                self.injected.append((op, path, hit.kind))
            return hit


# -- op-log recording (power-cut replay's raw material) -----------------------

@dataclasses.dataclass
class Op:
    """One successful syscall, as the replay harness needs it."""
    op: str                        # an OPS name
    path: str
    offset: int = 0                # pwrite: position of ``data``
    data: bytes = b""              # pwrite: the bytes actually written
    n: int = 0                     # truncate: new length; open: flags
    dst: str = ""                  # replace: destination path

    def __repr__(self) -> str:  # keep test failure output readable
        extra = f" +{len(self.data)}B@{self.offset}" if self.data else ""
        dst = f" -> {self.dst}" if self.dst else ""
        return f"<{self.op} {self.path}{extra}{dst}>"


class OpLog:
    """Thread-safe append-only list of :class:`Op` (background writeback
    jobs record from their worker threads; every op is appended at
    completion time, so happens-before edges in the code — drain before
    fsync, fsync before rename — are preserved in log order)."""

    def __init__(self) -> None:
        self.ops: List[Op] = []
        self._lock = threading.Lock()

    def append(self, op: Op) -> None:
        with self._lock:
            self.ops.append(op)

    def __len__(self) -> int:
        with self._lock:
            return len(self.ops)

    def __iter__(self):
        with self._lock:
            return iter(list(self.ops))


# -- activation ---------------------------------------------------------------

_state_lock = threading.Lock()
_installed: Optional[FaultInjector] = None
_recorder: Optional[OpLog] = None
# REPRO_SCDA_FAULTS cache: (raw spec string, injector) — the injector is
# reused while the string is unchanged so nth/count counters accumulate
# across calls, and re-parsed the moment a test flips the variable.
_env_cache: tuple = ("", None)


def install(plan) -> FaultInjector:
    """Install a process-wide fault plan (spec string or FaultPlan);
    returns the injector (``.injected`` is the assertion hook)."""
    global _installed
    inj = plan if isinstance(plan, FaultInjector) else FaultInjector(plan)
    with _state_lock:
        _installed = inj
    return inj


def uninstall() -> None:
    global _installed
    with _state_lock:
        _installed = None


class inject:
    """``with faults.inject("pwrite:errno=EIO"): ...`` — scoped install."""

    def __init__(self, plan):
        self.injector = plan if isinstance(plan, FaultInjector) \
            else FaultInjector(plan)

    def __enter__(self) -> FaultInjector:
        install(self.injector)
        return self.injector

    def __exit__(self, *exc) -> None:
        uninstall()


class record:
    """``with faults.record() as log: ...`` — capture every mutating
    syscall into an :class:`OpLog` (one recorder at a time)."""

    def __init__(self) -> None:
        self.log = OpLog()

    def __enter__(self) -> OpLog:
        global _recorder
        with _state_lock:
            _recorder = self.log
        return self.log

    def __exit__(self, *exc) -> None:
        global _recorder
        with _state_lock:
            _recorder = None


def _env_injector() -> Optional[FaultInjector]:
    global _env_cache
    spec = os.environ.get("REPRO_SCDA_FAULTS", "")
    if not spec:
        return None
    with _state_lock:
        if _env_cache[0] != spec:
            try:
                _env_cache = (spec, FaultInjector(spec))
            except ValueError:
                _env_cache = (spec, None)  # malformed spec: inert
        return _env_cache[1]


def active(inj: Optional[FaultInjector] = None) -> Optional[FaultInjector]:
    """The injector governing the current call: an explicitly scoped one
    (a :func:`FaultBackend`'s), else the installed one, else the
    environment's."""
    if inj is not None:
        return inj
    if _installed is not None:
        return _installed
    return _env_injector()


def _quiet() -> bool:
    return _installed is None and _recorder is None \
        and not os.environ.get("REPRO_SCDA_FAULTS")


def _decide(op: str, path: str, inj: Optional[FaultInjector]) \
        -> Optional[FaultRule]:
    cur = active(inj)
    return cur.decide(op, path) if cur is not None else None


def _apply_simple(act: Optional[FaultRule], op: str, path: str) \
        -> Optional[FaultRule]:
    """Raise for errno/crash actions; hand short/zero/torn back to the
    per-op wrapper (they change the completion, not the outcome)."""
    if act is None:
        return None
    c = _trace.collector()
    if c is not None:
        c.event(f"fault.{act.kind}", "io", op=op, path=path)
    if act.kind == "errno":
        raise OSError(act.errno_, os.strerror(act.errno_), path)
    if act.kind == "crash":
        raise SimulatedCrash(op, path)
    if act.kind == "missing":
        # Whole-file loss as this op sees it: ENOENT, file "gone".
        raise OSError(_errno.ENOENT, os.strerror(_errno.ENOENT), path)
    if act.kind == "unlink":
        # Whole-file loss for real: the dirent goes away; already-open
        # fds keep working on the orphaned inode (POSIX), later opens
        # fail naturally — exactly what losing a shard file looks like.
        try:
            os.unlink(path)
        except OSError:
            pass
        return None
    return act


def _record(op: Op) -> None:
    rec = _recorder
    if rec is not None:
        rec.append(op)


# -- instrumented syscalls ----------------------------------------------------
# Each wrapper: decide → maybe inject → real call → record → return.  The
# fast path (no injector, no recorder, no trace collector) is two function
# calls + a few global reads on top of the raw syscall; telemetry spans
# (op kind, path, offset, bytes, latency) are emitted only when
# ``trace.collector()`` is live, around the real syscall (injected early
# completions show up as ``fault.*`` events instead).

def os_open(path: str, flags: int, mode: int = 0o644,
            inj: Optional[FaultInjector] = None) -> int:
    c = _trace.collector()
    t0 = c.now() if c is not None else 0
    if not _quiet() or inj is not None:
        _apply_simple(_decide("open", path, inj), "open", path)
        fd = os.open(path, flags, mode)
        if flags & os.O_WRONLY or flags & os.O_RDWR:
            _record(Op("open", path, n=flags))
    else:
        fd = os.open(path, flags, mode)
    if c is not None:
        c.io_op("open", path, 0, 0, t0)
    return fd


def os_pwrite(fd: int, view, offset: int, path: str = "",
              inj: Optional[FaultInjector] = None) -> int:
    act = _apply_simple(_decide("pwrite", path, inj), "pwrite", path) \
        if (not _quiet() or inj is not None) else None
    if act is not None:
        if act.kind == "zero":
            return 0
        if act.kind in ("short", "torn"):
            view = view[:max(0, act.n)]
            if not len(view):
                return 0
    c = _trace.collector()
    t0 = c.now() if c is not None else 0
    n = os.pwrite(fd, view, offset)
    if c is not None:
        c.io_op("pwrite", path, offset, n, t0)
    if _recorder is not None:
        _record(Op("pwrite", path, offset=offset, data=bytes(view[:n])))
    return n


def os_pwritev(fd: int, views: Sequence, offset: int, path: str = "",
               inj: Optional[FaultInjector] = None) -> int:
    act = _apply_simple(_decide("pwritev", path, inj), "pwritev", path) \
        if (not _quiet() or inj is not None) else None
    if act is not None:
        if act.kind == "zero":
            return 0
        if act.kind == "torn":
            # Land fragments [0, F) for real, then die: the torn
            # multi-fragment write, cut exactly at a fragment boundary.
            cut = max(0, act.n)
            done = 0
            for v in views[:cut]:
                while done < len(v):
                    w = os.pwrite(fd, v[done:], offset + done)
                    done += w
                if _recorder is not None:
                    _record(Op("pwrite", path, offset=offset,
                               data=bytes(v)))
                offset += len(v)
                done = 0
            raise SimulatedCrash("pwritev", path,
                                 f"torn write cut at fragment {cut}")
        if act.kind == "short":
            # A short vectored completion of exactly K bytes: trim the
            # iovec list so the bytes on disk match the reported count.
            budget, trimmed = max(0, act.n), []
            for v in views:
                if budget <= 0:
                    break
                take = v[:budget] if len(v) > budget else v
                trimmed.append(take)
                budget -= len(take)
            if not trimmed:
                return 0
            views = trimmed
    if not hasattr(os, "pwritev"):  # pragma: no cover - exotic hosts
        n = 0
        for v in views:
            n += os_pwrite(fd, v, offset + n, path=path)
        return n
    c = _trace.collector()
    t0 = c.now() if c is not None else 0
    n = os.pwritev(fd, views, offset)
    if c is not None:
        c.io_op("pwritev", path, offset, n, t0)
    if _recorder is not None and n > 0:
        joined = b"".join(bytes(v) for v in views)
        _record(Op("pwritev", path, offset=offset, data=joined[:n]))
    return n


def os_pread(fd: int, n: int, offset: int, path: str = "",
             inj: Optional[FaultInjector] = None) -> bytes:
    if not _quiet() or inj is not None:
        act = _apply_simple(_decide("pread", path, inj), "pread", path)
        if act is not None:
            if act.kind == "zero":
                return b""
            if act.kind in ("short", "torn"):
                n = min(n, max(0, act.n))
                if n == 0:
                    return b""
    c = _trace.collector()
    if c is None:
        return os.pread(fd, n, offset)
    t0 = c.now()
    data = os.pread(fd, n, offset)
    c.io_op("pread", path, offset, len(data), t0)
    return data


def os_preadv(fd: int, views: Sequence, offset: int, path: str = "",
              inj: Optional[FaultInjector] = None) -> int:
    if not _quiet() or inj is not None:
        act = _apply_simple(_decide("preadv", path, inj), "preadv", path)
        if act is not None:
            if act.kind == "zero":
                return 0
            if act.kind in ("short", "torn"):
                budget, trimmed = max(0, act.n), []
                for v in views:
                    if budget <= 0:
                        break
                    take = v[:budget] if len(v) > budget else v
                    trimmed.append(take)
                    budget -= len(take)
                if not trimmed:
                    return 0
                views = trimmed
    if not hasattr(os, "preadv"):  # pragma: no cover - exotic hosts
        got = 0
        for v in views:
            data = os.pread(fd, len(v), offset + got)
            v[:len(data)] = data
            got += len(data)
            if len(data) < len(v):
                break
        return got
    c = _trace.collector()
    if c is None:
        return os.preadv(fd, views, offset)
    t0 = c.now()
    n = os.preadv(fd, views, offset)
    c.io_op("preadv", path, offset, n, t0)
    return n


def os_fsync(fd: int, path: str = "",
             inj: Optional[FaultInjector] = None) -> None:
    c = _trace.collector()
    t0 = c.now() if c is not None else 0
    if not _quiet() or inj is not None:
        _apply_simple(_decide("fsync", path, inj), "fsync", path)
        os.fsync(fd)
        _record(Op("fsync", path))
    else:
        os.fsync(fd)
    if c is not None:
        c.io_op("fsync", path, 0, 0, t0)


def os_ftruncate(fd: int, length: int, path: str = "",
                 inj: Optional[FaultInjector] = None) -> None:
    c = _trace.collector()
    t0 = c.now() if c is not None else 0
    if not _quiet() or inj is not None:
        _apply_simple(_decide("truncate", path, inj), "truncate", path)
        os.ftruncate(fd, length)
        _record(Op("truncate", path, n=length))
    else:
        os.ftruncate(fd, length)
    if c is not None:
        c.io_op("truncate", path, length, 0, t0)


def os_replace(src: str, dst: str,
               inj: Optional[FaultInjector] = None) -> None:
    c = _trace.collector()
    t0 = c.now() if c is not None else 0
    if not _quiet() or inj is not None:
        _apply_simple(_decide("replace", dst, inj), "replace", dst)
        os.replace(src, dst)
        _record(Op("replace", src, dst=dst))
    else:
        os.replace(src, dst)
    if c is not None:
        c.io_op("replace", dst, 0, 0, t0)


def os_fsync_dir(path: str,
                 inj: Optional[FaultInjector] = None) -> None:
    """fsync a DIRECTORY — what makes a rename durable.  POSIX: the
    rename itself only mutates the in-memory dirent; power loss before
    the directory inode reaches disk can undo an "atomic commit"."""
    c = _trace.collector()
    t0 = c.now() if c is not None else 0
    if not _quiet() or inj is not None:
        _apply_simple(_decide("fsync_dir", path, inj), "fsync_dir", path)
    fd = os.open(path or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    _record(Op("fsync_dir", path))
    if c is not None:
        c.io_op("fsync_dir", path, 0, 0, t0)


# -- the test-facing backend shim ---------------------------------------------

def FaultBackend(path: str, mode: str, create: bool, plan,
                 readahead: Optional[int] = None):
    """A :class:`~repro.core.io_backend.FileBackend` whose syscalls run
    under a private fault plan — scoped to this one file, unlike
    :func:`install`.  Background writeback and prefetch jobs re-enter the
    backend's own methods, so they see the same plan from their worker
    threads (the injector's counters are thread-safe).

    A factory rather than a subclass: the backend carries its injector in
    ``_inj``, which every instrumented syscall wrapper receives — the
    import dependency stays one-way (io_backend → faults).
    """
    from repro_torch.core.io_backend import FileBackend
    backend = FileBackend(path, mode, create, readahead)
    backend._inj = plan if isinstance(plan, FaultInjector) \
        else FaultInjector(plan)
    return backend
