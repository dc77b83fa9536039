"""End-to-end I/O telemetry — spans, counters, and Chrome traces.

The stack runs five overlapping asynchronous engines (iovec writer,
writeback executor, prefetch pipeline, codec pool, sharded/parity
commit); this module is the one place they all report to, so a save or
restore can be profiled per stage instead of bisected.  Three sinks:

* **In-memory metrics** — :class:`Metrics` aggregates counters and
  latency histograms; ``Metrics.snapshot()`` returns a plain dict
  (``scdatool verify --timing`` and the benchmark harness read it).
* **Chrome ``trace_event`` JSON** — every span becomes a complete
  ("X") event with real thread ids, so the codec/writeback/prefetch
  pools show up as separate tracks in ``chrome://tracing`` / Perfetto.
* **Journal records** — :meth:`TraceCollector.commit_record` returns
  the per-commit counter deltas as a flat scalar pytree; the checkpoint
  manager flushes them into the archive's own journal
  (``repro.journal``), so telemetry is archived in-format.

Activation mirrors :mod:`repro.core.faults`: the quiet path is one
module-global load plus one environ lookup and allocates nothing —
``collector()`` returns None and every instrumentation site bails.
``REPRO_SCDA_TRACE=mem`` (or ``1``) collects in memory;
``REPRO_SCDA_TRACE=/path/trace.json`` additionally exports the Chrome
trace at process exit (and on :func:`flush`).  Programmatic use:
``install()`` / ``uninstall()`` / ``scoped()`` (what
``pytree_io.save(trace=...)`` rides).

Tracing never perturbs bytes: instrumented code paths are fuzzed
byte-identical to untraced runs by ``tests/test_trace.py``.

The compute path (``train.step``, ``models.lm``, ``models.ssm``,
``kernels.ops``) opens :func:`compute` spans.  They are live while a
collector is installed or a ``torch.profiler`` window records (with no
collector installed, the first live span installs one that is live only
in profiler windows and stays readable after them).  A live one records
its host interval, its parent and root span, a pair of CUDA timing events
on the current stream (taken from a pool, read and given back after one
synchronize when the spans are read, :meth:`TraceCollector.spans`, or,
past ``HOLD_SPANS``, once the card has passed them, never waited for),
and under the profiler a range named ``<cat>.<name>``.  Host and device
intervals are mapped onto the Unix-epoch clock that the profiler's rows
are on, so the collector's Chrome export (a ``cuda:<i>`` track beside the
host threads) lays over the profiler's.  Compute spans never enter
:meth:`TraceCollector.commit_record`.  Off, a span is one global load and
the profiler's flag, and allocates nothing.

:func:`warn` is the single user-facing warning channel (degraded reads,
stale-lock takeover): logging-backed (logger ``repro.scda`` — capture
it with ``caplog`` in tests; without handlers it still lands on stderr
via logging's last-resort handler), rate-limited per message key, and
counted in the active collector's metrics.
"""
from __future__ import annotations

import atexit
import dataclasses
import itertools
import json
import logging
import os
import sys
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

#: ``REPRO_SCDA_TRACE``: ``mem``/``1`` = collect in memory; any other
#: value = also export Chrome trace JSON to that path at process exit.
TRACE_ENV = "REPRO_SCDA_TRACE"

#: Event cap per collector — beyond it events drop (counted), metrics
#: keep aggregating.  A full sharded+parity save is ~10k events.
DEFAULT_MAX_EVENTS = 1_000_000

#: Compute-path spans a collector keeps; beyond it they drop, counted
#: with the dropped events.  A falcon-mamba train step at 8 layers
#: records 216, a prefill 76.
MAX_SPANS = 100_000

#: Closed spans whose CUDA events a collector holds until a read; beyond
#: it, each root span's close gives back the events the card has passed
#: (:meth:`TraceCollector._harvest`, about 13 µs of host time a span on
#: one H100 machine), so a traced window of the benchmark's cells (under
#: 2,000 spans) pays that only at its read.
HOLD_SPANS = 32_768

#: Tries at a device mark's host time (:meth:`TraceCollector._mark`).
MARK_TRIES = 8

logger = logging.getLogger("repro.scda")

_collector: Optional["TraceCollector"] = None
_atexit_registered = False


# --------------------------------------------------------------------------
# Metrics: counters + latency histograms
# --------------------------------------------------------------------------

class Metrics:
    """Aggregated counters and log2-bucket latency histograms.

    Thread-safe; update cost is one lock + two dict ops, which is noise
    next to the syscalls being measured.  ``snapshot()`` is the read
    API — a plain nested dict, JSON-able as-is.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        # name -> [count, total, min, max, {bucket: count}] (µs values)
        self._hists: Dict[str, list] = {}

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def observe(self, name: str, value_us: float) -> None:
        """Record one latency/size observation (microseconds by
        convention for ``*.us`` names)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = [0, 0.0, value_us, value_us, {}]
                self._hists[name] = h
            h[0] += 1
            h[1] += value_us
            if value_us < h[2]:
                h[2] = value_us
            if value_us > h[3]:
                h[3] = value_us
            b = max(0, int(value_us)).bit_length()
            h[4][b] = h[4].get(b, 0) + 1

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self) -> Dict[str, Any]:
        """``{"counters": {...}, "histograms": {name: {count, total_us,
        mean_us, min_us, max_us, p50_us, p99_us}}}`` — a stable plain
        dict copy."""
        with self._lock:
            counters = dict(self._counters)
            hists = {k: (h[0], h[1], h[2], h[3], dict(h[4]))
                     for k, h in self._hists.items()}
        out_h: Dict[str, Any] = {}
        for name, (count, total, mn, mx, buckets) in hists.items():
            out_h[name] = {
                "count": count,
                "total_us": round(total, 3),
                "mean_us": round(total / count, 3) if count else 0.0,
                "min_us": round(mn, 3),
                "max_us": round(mx, 3),
                "p50_us": _bucket_quantile(buckets, count, 0.50),
                "p99_us": _bucket_quantile(buckets, count, 0.99),
            }
        return {"counters": counters, "histograms": out_h}


def _bucket_quantile(buckets: Dict[int, int], count: int,
                     q: float) -> float:
    """Upper bound of the log2 bucket holding quantile ``q`` (µs)."""
    if not count:
        return 0.0
    want = max(1, int(count * q))
    seen = 0
    for b in sorted(buckets):
        seen += buckets[b]
        if seen >= want:
            return float(1 << b)
    return float(1 << max(buckets))


# --------------------------------------------------------------------------
# The collector
# --------------------------------------------------------------------------

class _Span:
    """Context manager emitting one complete event on exit."""
    __slots__ = ("_c", "_name", "_cat", "_args", "_t0")

    def __init__(self, c: "TraceCollector", name: str, cat: str,
                 args: Optional[Dict[str, Any]]) -> None:
        self._c, self._name, self._cat, self._args = c, name, cat, args
        self._t0 = 0

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def add(self, **kw: Any) -> None:
        """Attach args discovered mid-span (e.g. a result size)."""
        if self._args is None:
            self._args = kw
        else:
            self._args.update(kw)

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.add(error=f"{exc_type.__name__}: {exc}")
        self._c.end(self._name, self._cat, self._t0, self._args)


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One closed compute-path span (:meth:`TraceCollector.spans`).

    Times are nanoseconds on the Unix-epoch clock, the one
    ``torch.profiler``'s rows are on.  The device interval runs from the
    stream reaching the span's first event to the end of its last, idle
    inside included; it is None where the span recorded no CUDA events
    (off CUDA), never a host time."""
    name: str
    cat: str
    id: int
    parent: Optional[int]
    root: int
    thread: int
    host_start_ns: int
    host_end_ns: int
    device: Optional[int]
    device_start_ns: Optional[int]
    device_end_ns: Optional[int]
    args: Dict[str, Any]

    @property
    def key(self) -> str:
        """``<cat>.<name>``, the span's name in profiles and metrics."""
        return f"{self.cat}.{self.name}"

    @property
    def device_ns(self) -> Optional[int]:
        if self.device_start_ns is None:
            return None
        return self.device_end_ns - self.device_start_ns


class _ComputeSpan:
    """A live compute-path span: ``start()`` and ``stop()`` (a backward
    mark opens and closes in two autograd calls), or ``with``.

    On CUDA its two timing events come from the collector's pool and go
    back to it once they are read (:meth:`TraceCollector._harvest`): what
    is kept is their offsets in ns from the first event of its ``base``,
    its root span (or itself, where the root recorded no event on its
    device), whose event is kept until a read maps it onto the epoch
    clock."""
    __slots__ = ("_c", "name", "cat", "backward", "args", "recompute", "id",
                 "parent", "root", "thread", "t0", "t1", "dev", "base", "ev0",
                 "ev1", "off0", "off1", "epoch", "_rf", "_stack")

    def __init__(self, c: "TraceCollector", name: str, cat: str,
                 backward: bool) -> None:
        self._c, self.name, self.cat = c, name, cat
        self.backward = backward
        self.args: Optional[Dict[str, Any]] = None
        self.dev = self.ev0 = self.ev1 = self._rf = None
        self.off0 = self.off1 = self.epoch = None

    def add(self, **kw: Any) -> None:
        if self.args is None:
            self.args = kw
        else:
            self.args.update(kw)

    def start(self) -> "_ComputeSpan":
        c = self._c
        torch = sys.modules["torch"]
        stack = c._thread_stack()
        in_backward = torch._C._current_graph_task_id() != -1
        if stack:
            parent = stack[-1]
        elif in_backward and c._backward:
            parent = c._backward[-1]      # autograd's own thread
        else:
            parent = None
        self.id = next(c._ids)
        self.parent = parent
        self.root = self if parent is None else parent.root
        self.thread = threading.get_ident()
        # forward code that autograd runs is remat's recompute
        self.recompute = None if self.backward else in_backward
        if (_profiler_enabled or _bind_profiler_flag())():
            # the range opens first: its row starts just before t0
            self._rf = _RecordFunctionFast(f"{self.cat}.{self.name}")
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        if torch.cuda.is_initialized():
            self.dev = dev = torch.cuda.current_device()
            self.ev0 = c._record(dev)
            r = self.root
            self.base = r if r.dev == dev and r.ev0 is not None else self
        stack.append(self)
        self._stack = stack
        if self.backward:
            c._backward.append(self)
        return self

    def stop(self) -> None:
        c = self._c
        if self.ev0 is not None:
            self.ev1 = c._record(self.dev)
        self.t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        stack = self._stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if self.backward and self in c._backward:
            c._backward.remove(self)
        c._close(self)
        # no cycle through the collector: dropped, it is freed at once
        self._c = self._stack = None

    def __enter__(self) -> "_ComputeSpan":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.add(error=f"{exc_type.__name__}: {exc}")
        self.stop()


class TraceCollector:
    """One trace session: an event buffer plus aggregated metrics.

    Event emission is designed for the hot paths: a tuple append under
    the GIL (no lock) plus a locked metrics update.  Thread ids are
    real (:func:`threading.get_ident`), so the ``scda-codec`` /
    ``scda-writeback`` / ``scda-prefetch`` pools get their own Chrome
    tracks.  ``path`` (optional) is where :meth:`export` writes the
    Chrome JSON by default.
    """

    def __init__(self, path: Optional[str] = None,
                 max_events: int = DEFAULT_MAX_EVENTS) -> None:
        self.path = path
        self.max_events = max_events
        self.metrics = Metrics()
        # (name, cat, ph, ts_ns, dur_ns, tid, args-or-None)
        self._events: List[tuple] = []
        self._dropped = 0
        self._pid = os.getpid()
        self._epoch_ns = time.perf_counter_ns()
        self._commit_base: Dict[str, int] = {}
        self._commit_lock = threading.Lock()
        # compute-path spans: the Unix-epoch time at ``_epoch_ns`` (the
        # profiler's clock), whether the collector is the one a profiler
        # window installed (live in such windows only), closed spans,
        # those whose events the card may not have passed yet, live
        # backward spans, the timing events to reuse, by device, and the
        # devices' streams
        self._epoch_time_ns = time.time_ns() - (time.perf_counter_ns()
                                                - self._epoch_ns)
        self.profiler_only = False
        self._spans: List[_ComputeSpan] = []
        self._unread: List[_ComputeSpan] = []
        self._backward: List[_ComputeSpan] = []
        self._free: Dict[int, List[Any]] = {}
        self._streams: Dict[tuple, Any] = {}
        self._ids = itertools.count(1)
        self._tls = threading.local()

    # -- emission ----------------------------------------------------------

    @staticmethod
    def now() -> int:
        """Span start timestamp (ns); pair with :meth:`end`/``io_op``."""
        return time.perf_counter_ns()

    def _emit(self, name: str, cat: str, ph: str, ts: int, dur: int,
              args: Optional[Dict[str, Any]]) -> None:
        if len(self._events) >= self.max_events:
            self._dropped += 1
            return
        self._events.append(
            (name, cat, ph, ts, dur, threading.get_ident(), args))

    def end(self, name: str, cat: str, t0: int,
            args: Optional[Dict[str, Any]] = None) -> None:
        """Close a span opened at ``t0 = now()`` — one "X" event plus
        per-stage call/latency (and bytes, when given) metrics."""
        t1 = time.perf_counter_ns()
        m = self.metrics
        key = f"{cat}.{name}"
        m.count(key + ".calls")
        m.observe(key + ".us", (t1 - t0) / 1000.0)
        if args:
            b = args.get("bytes")
            if b:
                m.count(key + ".bytes", int(b))
        self._emit(name, cat, "X", t0, t1 - t0, args)

    def span(self, name: str, cat: str = "ckpt",
             **args: Any) -> _Span:
        return _Span(self, name, cat, args or None)

    def io_op(self, op: str, path: str, offset: int, nbytes: int,
              t0: int, error: Optional[str] = None) -> None:
        """One syscall through the :mod:`repro.core.faults` choke
        point: op kind, path, offset, bytes moved, latency."""
        t1 = time.perf_counter_ns()
        m = self.metrics
        m.count(f"io.{op}.calls")
        if nbytes:
            m.count(f"io.{op}.bytes", nbytes)
        m.observe(f"io.{op}.us", (t1 - t0) / 1000.0)
        args: Dict[str, Any] = {"path": path, "offset": offset,
                                "bytes": nbytes}
        if error is not None:
            m.count(f"io.{op}.errors")
            args["error"] = error
        self._emit(op, "io", "X", t0, t1 - t0, args)

    def event(self, name: str, cat: str = "ckpt", **args: Any) -> None:
        """Instant event (lifecycle marks: commit, takeover, …)."""
        self.metrics.count(f"{cat}.{name}")
        self._emit(name, cat, "i", time.perf_counter_ns(), 0,
                   args or None)

    def counter(self, name: str, value: int,
                cat: str = "pipeline") -> None:
        """Chrome "C" counter sample (queue depth, in-flight bytes)."""
        self._emit(name, cat, "C", time.perf_counter_ns(), 0,
                   {"value": int(value)})

    # -- compute-path spans ------------------------------------------------

    def compute(self, name: str, cat: str, *,
                backward: bool = False) -> _ComputeSpan:
        """A compute-path span of this collector, not yet started (the
        module's :func:`compute` is the call sites' entry)."""
        return _ComputeSpan(self, name, cat, backward)

    def _thread_stack(self) -> List[_ComputeSpan]:
        try:
            return self._tls.stack
        except AttributeError:
            stack = self._tls.stack = []
            return stack

    def _record(self, dev: int) -> Any:
        """A timing event recorded on ``dev``'s current stream, from the
        pool if one is free (``torch.cuda.current_stream`` builds a new
        stream object, 8 µs on one H100 machine: this looks it up)."""
        torch = sys.modules["torch"]
        free = self._free.get(dev)
        ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
        key = torch._C._cuda_getCurrentStream(dev)
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.current_stream(dev)
        ev.record(stream)
        return ev

    def _close(self, sp: _ComputeSpan) -> None:
        if len(self._spans) >= MAX_SPANS:
            self._dropped += 1
            return
        self._spans.append(sp)
        if sp.ev1 is not None:
            self._unread.append(sp)
            if sp.parent is None and len(self._unread) > HOLD_SPANS:
                self._harvest()

    def _harvest(self) -> None:
        """Without waiting: the closed spans whose events the card has
        passed, in the order they closed, get their offsets from their
        base's first event, and give back their events (a base keeps its
        first until it is mapped)."""
        n = 0
        for s in self._unread:
            b = s.base
            if not (s.ev1.query() and b.ev0.query()):
                break
            s.off0 = 0 if b is s else round(b.ev0.elapsed_time(s.ev0) * 1e6)
            s.off1 = s.off0 + round(s.ev0.elapsed_time(s.ev1) * 1e6)
            free = self._free.setdefault(s.dev, [])
            free.append(s.ev1)
            s.ev1 = None
            if b is not s:
                free.append(s.ev0)
                s.ev0 = None
            n += 1
        del self._unread[:n]

    def _to_epoch(self, perf_ns: int) -> int:
        return self._epoch_time_ns + (perf_ns - self._epoch_ns)

    def _mark(self, dev: int) -> Tuple[Any, int]:
        """A timing event recorded on ``dev`` once it is idle, and the
        epoch time it ran at: the middle of the host's clock from before
        its record to the end of the wait for it, the tightest of
        ``MARK_TRIES`` (an idle card may take tens of µs to reach a
        command, and the host may stall after the wait).  The wait spins
        on the event: a blocking wait gives up the GIL, and taking it
        back after another thread held it put a mark 0.13 ms late on
        one H100 machine."""
        torch = sys.modules["torch"]
        best = None
        with torch.cuda.device(dev):
            torch.cuda.synchronize()
            for _ in range(MARK_TRIES):
                ev = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter_ns()
                ev.record()
                while not ev.query():
                    pass
                t1 = time.perf_counter_ns()
                if best is None or t1 - t0 < best[2] - best[1]:
                    best = (ev, t0, t1)
        ev, t0, t1 = best
        return ev, self._to_epoch((t0 + t1) // 2)

    def _resolve(self) -> None:
        """Map the closed spans not read yet onto the epoch clock: one
        synchronize and mark a device (:meth:`_mark`), then each base's
        first event counted back from the mark.  The card's timer drifts
        from the host's clock (about 3 ppm on one H100 machine; the
        profiler's device rows follow the host's), so a span mapped
        long after it ran sits that much off the profiler's rows: 0.1 ms
        at 45 s."""
        todo = [s for s in self._spans if s.dev is not None
                and (s.off1 is None or s.base.epoch is None)]
        if not todo:
            return
        marks = {d: self._mark(d) for d in {s.dev for s in todo}}
        self._harvest()          # the card has passed every event now
        for b in {s.base for s in todo}:
            if b.epoch is None:
                ev, at = marks[b.dev]
                b.epoch = at - round(b.ev0.elapsed_time(ev) * 1e6)
            if b.off1 is not None:        # closed and read: done with it
                self._free.setdefault(b.dev, []).append(b.ev0)
                b.ev0 = None

    def spans(self) -> List[SpanRecord]:
        """Every closed compute-path span, by host start time.  The first
        read after device spans closed synchronizes their devices."""
        self._resolve()
        out = []
        for s in list(self._spans):
            dev0 = dev1 = None
            if s.dev is not None:
                dev0, dev1 = s.base.epoch + s.off0, s.base.epoch + s.off1
            args = dict(s.args or ())
            if s.recompute is not None:
                args["recompute"] = s.recompute
            out.append(SpanRecord(
                s.name, s.cat, s.id, None if s.parent is None else s.parent.id,
                s.root.id, s.thread, self._to_epoch(s.t0),
                self._to_epoch(s.t1), s.dev, dev0, dev1, args))
        out.sort(key=lambda r: r.host_start_ns)
        return out

    def _chrome_spans(self) -> List[Dict[str, Any]]:
        """The compute spans' Chrome events: each on its host thread, and
        its device interval on a ``cuda:<i>`` track; ``ts`` counts from
        ``baseTimeNanoseconds`` (:meth:`chrome`), as in
        ``torch.profiler``'s export."""
        events: List[Dict[str, Any]] = []
        base = self._epoch_time_ns
        devices = set()
        for r in self.spans() if self._spans else ():
            events.append({
                "name": r.name, "cat": r.cat, "ph": "X", "pid": self._pid,
                "tid": r.thread, "ts": (r.host_start_ns - base) / 1000.0,
                "dur": (r.host_end_ns - r.host_start_ns) / 1000.0,
                "args": dict(r.args, id=r.id, parent=r.parent)})
            if r.device is not None:
                devices.add(r.device)
                events.append({
                    "name": r.key, "cat": "cuda", "ph": "X",
                    "pid": self._pid, "tid": -1 - r.device,
                    "ts": (r.device_start_ns - base) / 1000.0,
                    "dur": r.device_ns / 1000.0, "args": {"id": r.id}})
        for d in sorted(devices):
            events.append({"name": "thread_name", "ph": "M",
                           "pid": self._pid, "tid": -1 - d,
                           "args": {"name": f"cuda:{d}"}})
        return events

    # -- sinks -------------------------------------------------------------

    def chrome(self) -> Dict[str, Any]:
        """The Chrome ``trace_event`` document (object form)."""
        events: List[Dict[str, Any]] = []
        for name, cat, ph, ts, dur, tid, args in list(self._events):
            ev: Dict[str, Any] = {
                "name": name, "cat": cat, "ph": ph,
                "pid": self._pid, "tid": tid,
                "ts": (ts - self._epoch_ns) / 1000.0,
            }
            if ph == "X":
                ev["dur"] = dur / 1000.0
            if args:
                ev["args"] = args
            events.append(ev)
        events.extend(self._chrome_spans())
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"tool": "repro-scda",
                             "dropped_events": self._dropped}}
        # ``ts`` is µs after this time on the Unix-epoch clock
        doc["baseTimeNanoseconds"] = self._epoch_time_ns
        return doc

    def export(self, path: Optional[str] = None) -> str:
        """Write the Chrome trace JSON; returns the path written."""
        target = path or self.path
        if not target:
            raise ValueError("no export path: pass one or construct "
                             "the collector with path=")
        with open(target, "w") as fh:
            json.dump(self.chrome(), fh)
            fh.write("\n")
        return target

    def commit_record(self) -> Dict[str, int]:
        """Counter deltas since the previous call — the per-commit
        metric record the checkpoint manager journals.  First call
        returns the totals so far."""
        snap = self.metrics.snapshot()["counters"]
        with self._commit_lock:
            base = self._commit_base
            delta = {k: v - base.get(k, 0) for k, v in snap.items()
                     if v - base.get(k, 0)}
            self._commit_base = snap
        return delta


# --------------------------------------------------------------------------
# Module-level activation (the faults.py pattern)
# --------------------------------------------------------------------------

def collector() -> Optional["TraceCollector"]:
    """The active collector, or None (the common, quiet case).

    The quiet path is one global load and one environ lookup —
    zero-allocation, the same discipline as ``faults._quiet()``.  When
    ``REPRO_SCDA_TRACE`` is set and nothing is installed yet, a
    collector is installed lazily from the environment.
    """
    c = _collector
    if c is not None:
        return c
    if not os.environ.get(TRACE_ENV):
        return None
    return _install_from_env()


def _install_from_env() -> "TraceCollector":
    global _atexit_registered
    raw = os.environ.get(TRACE_ENV, "").strip()
    path = None if raw in ("1", "mem", "memory") else raw or None
    c = install(TraceCollector(path=path))
    if path and not _atexit_registered:
        _atexit_registered = True
        atexit.register(flush)
    return c


def install(c: Optional["TraceCollector"] = None) -> "TraceCollector":
    """Install ``c`` (or a fresh collector) as the process-wide sink."""
    global _collector
    if c is None:
        c = TraceCollector()
    _collector = c
    return c


def uninstall() -> Optional["TraceCollector"]:
    """Deactivate tracing; returns the collector that was active."""
    global _collector
    c = _collector
    _collector = None
    return c


def flush() -> Optional[str]:
    """Export the active collector's Chrome trace to its path (no-op
    without a collector or path) — also the atexit hook for
    ``REPRO_SCDA_TRACE=/path.json`` runs."""
    c = _collector
    if c is not None and c.path:
        try:
            return c.export()
        except OSError:
            return None
    return None


class scoped:
    """``with trace.scoped(tc):`` — install for the duration, restore
    the previous sink after.  ``tc`` may be a :class:`TraceCollector`
    or a path string (a fresh collector exporting there on exit).
    What ``pytree_io.save(trace=...)`` uses."""

    def __init__(self, tc) -> None:
        if isinstance(tc, TraceCollector):
            self.collector = tc
            self._export = False
        else:
            self.collector = TraceCollector(path=str(tc))
            self._export = True
        self._prev: Optional[TraceCollector] = None

    def __enter__(self) -> TraceCollector:
        global _collector
        self._prev = _collector
        _collector = self.collector
        return self.collector

    def __exit__(self, exc_type, exc, tb) -> None:
        global _collector
        _collector = self._prev
        if self._export and self.collector.path:
            try:
                self.collector.export()
            except OSError:
                pass


# Convenience wrappers for lifecycle (cold) call sites.  Hot paths
# should hold the collector and guard explicitly instead — these build
# kwargs dicts before the quiet check.

class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def add(self, **kw: Any) -> None:
        pass

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NULL_SPAN = _NullSpan()


def span(name: str, cat: str = "ckpt", **args: Any):
    c = collector()
    return _NULL_SPAN if c is None else c.span(name, cat, **args)


def event(name: str, cat: str = "ckpt", **args: Any) -> None:
    c = collector()
    if c is not None:
        c.event(name, cat, **args)


# --------------------------------------------------------------------------
# Compute-path spans
# --------------------------------------------------------------------------

#: ``torch._C._autograd._profiler_enabled`` and the profiler's light
#: range (``RecordFunctionFast``: about 1 µs a range under the profiler,
#: against 16 µs for ``record_function``'s ops, and no device-side copy of
#: the range among the profile's device rows), bound at the first call
#: once torch is imported (this module imports no torch: the scda I/O
#: stack runs without it).
_profiler_enabled = _RecordFunctionFast = None
_install_lock = threading.Lock()


def _no_profiler() -> bool:
    return False


def _bind_profiler_flag():
    global _profiler_enabled, _RecordFunctionFast
    torch = sys.modules.get("torch")
    if torch is None:
        return _no_profiler      # no profiler can record without torch
    _RecordFunctionFast = torch._C._profiler._RecordFunctionFast
    _profiler_enabled = torch._C._autograd._profiler_enabled
    return _profiler_enabled


class _NullCompute(_NullSpan):
    """An off compute span: false, so ``if span: span.add(...)`` builds no
    arguments while nothing records."""
    __slots__ = ()

    def __bool__(self) -> bool:
        return False


_NULL_COMPUTE = _NullCompute()


def live() -> Optional["TraceCollector"]:
    """The collector compute-path spans record into, or None: the
    installed collector, or while a ``torch.profiler`` window records,
    the profiler's (installed by the first such span if none is).

    Reads no environment: the step builders install a
    ``REPRO_SCDA_TRACE`` collector once, through :func:`collector`."""
    c = _collector
    if c is not None and not c.profiler_only:
        return c
    if not (_profiler_enabled or _bind_profiler_flag())():
        return None
    return c if c is not None else _install_for_profiler()


def _install_for_profiler() -> "TraceCollector":
    global _collector
    with _install_lock:
        if _collector is None:
            c = TraceCollector()
            c.profiler_only = True
            _collector = c
        return _collector


def compute(name: str, cat: str, *, backward: bool = False):
    """A compute-path span, ``<cat>.<name>``:
    ``with trace.compute("layer", "model") as s: if s: s.add(i=i)``.
    Off it is a shared null span (false).  Live it records its host
    interval, parent and root, CUDA events, a profiler range ``<cat>.<name>``
    under the profiler, and ``recompute``: whether autograd ran it, i.e.
    remat's recompute of forward code.  ``backward`` marks a span of
    backward work (no ``recompute``); while one is live, a span that
    opens on autograd's own thread with nothing open there takes it as
    its parent."""
    c = live()
    return _NULL_COMPUTE if c is None else _ComputeSpan(c, name, cat,
                                                        backward)


# --------------------------------------------------------------------------
# warn(): the single user-facing warning channel
# --------------------------------------------------------------------------

_warn_lock = threading.Lock()
_warn_last: Dict[str, float] = {}
_warn_suppressed: Dict[str, int] = {}

#: Default suppression window for repeated warnings with the same key.
WARN_INTERVAL_S = 60.0


def warn(msg: str, *, key: Optional[str] = None,
         interval: float = WARN_INTERVAL_S) -> bool:
    """Emit one user-facing warning line; returns True if emitted.

    Logging-backed (logger ``repro.scda`` at WARNING — without
    configured handlers, logging's last-resort handler still writes it
    to ``sys.stderr``, preserving the historical loud behavior), and
    rate-limited: repeats with the same ``key`` (default: the message
    itself) within ``interval`` seconds are suppressed and counted.
    ``interval=0`` disables the limit for that call.  The active
    collector counts every call (``warn.emitted`` / ``warn.suppressed``)
    and records emitted warnings as instant events.
    """
    k = key if key is not None else msg
    now = time.monotonic()
    if interval > 0:
        with _warn_lock:
            last = _warn_last.get(k)
            if last is not None and now - last < interval:
                _warn_suppressed[k] = _warn_suppressed.get(k, 0) + 1
                c = _collector
                if c is not None:
                    c.metrics.count("warn.suppressed")
                return False
            _warn_last[k] = now
    logger.warning("repro: %s", msg)
    c = _collector
    if c is not None:
        c.metrics.count("warn.emitted")
        c.event("warn", "warn", message=msg)
    return True


def reset_warn_limits() -> None:
    """Forget rate-limit state (test isolation)."""
    with _warn_lock:
        _warn_last.clear()
        _warn_suppressed.clear()


# --------------------------------------------------------------------------
# Chrome-trace summarization (scdatool stats --trace / bench --trace)
# --------------------------------------------------------------------------

def load_chrome(path: str) -> List[Dict[str, Any]]:
    """The event list of a Chrome trace file (object or array form)."""
    with open(path) as fh:
        doc = json.load(fh)
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) \
        else doc
    if not isinstance(events, list):
        raise ValueError(f"{path}: not a trace_event document")
    return events


def summarize_chrome(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-stage breakdown of a Chrome trace: for every complete-event
    ``cat.name``, total/self time, call count, bytes moved, effective
    MB/s — plus wall time (first ts → last ts+dur) and syscall totals.
    """
    stages: Dict[str, Dict[str, Any]] = {}
    t_min = None
    t_max = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        ts = float(ev.get("ts", 0.0))
        dur = float(ev.get("dur", 0.0))
        t_min = ts if t_min is None else min(t_min, ts)
        t_max = ts + dur if t_max is None else max(t_max, ts + dur)
        key = f"{ev.get('cat', '?')}.{ev.get('name', '?')}"
        st = stages.setdefault(key, {"calls": 0, "total_us": 0.0,
                                     "bytes": 0})
        st["calls"] += 1
        st["total_us"] += dur
        b = (ev.get("args") or {}).get("bytes")
        if b:
            st["bytes"] += int(b)
    for st in stages.values():
        st["total_us"] = round(st["total_us"], 1)
        if st["bytes"] and st["total_us"]:
            st["MBps"] = round(
                st["bytes"] / (st["total_us"] / 1e6) / 1e6, 1)
    wall = round((t_max - t_min), 1) if t_min is not None else 0.0
    io_calls = sum(st["calls"] for k, st in stages.items()
                   if k.startswith("io."))
    io_bytes = sum(st["bytes"] for k, st in stages.items()
                   if k.startswith("io."))
    return {"wall_us": wall, "stages": stages,
            "io_calls": io_calls, "io_bytes": io_bytes}


def format_summary(summary: Dict[str, Any]) -> Iterator[str]:
    """Human-readable lines of a :func:`summarize_chrome` result."""
    wall = summary["wall_us"]
    yield (f"wall {wall / 1e3:.1f} ms, {summary['io_calls']} syscalls, "
           f"{summary['io_bytes']} bytes moved")
    yield (f"{'stage':<28} {'calls':>7} {'total':>10} {'%wall':>6} "
           f"{'bytes':>12} {'MB/s':>8}")
    items: List[Tuple[str, Dict[str, Any]]] = sorted(
        summary["stages"].items(),
        key=lambda kv: -kv[1]["total_us"])
    for name, st in items:
        pct = 100.0 * st["total_us"] / wall if wall else 0.0
        mbps = st.get("MBps")
        yield (f"{name:<28} {st['calls']:>7} "
               f"{st['total_us'] / 1e3:>8.1f}ms {pct:>5.1f}% "
               f"{st['bytes']:>12} "
               f"{mbps if mbps is not None else '-':>8}")
