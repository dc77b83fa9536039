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

:func:`warn` is the single user-facing warning channel (degraded reads,
stale-lock takeover): logging-backed (logger ``repro.scda`` — capture
it with ``caplog`` in tests; without handlers it still lands on stderr
via logging's last-resort handler), rate-limited per message key, and
counted in the active collector's metrics.
"""
from __future__ import annotations

import atexit
import json
import logging
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

#: ``REPRO_SCDA_TRACE``: ``mem``/``1`` = collect in memory; any other
#: value = also export Chrome trace JSON to that path at process exit.
TRACE_ENV = "REPRO_SCDA_TRACE"

#: Event cap per collector — beyond it events drop (counted), metrics
#: keep aggregating.  A full sharded+parity save is ~10k events.
DEFAULT_MAX_EVENTS = 1_000_000

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
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"tool": "repro-scda",
                             "dropped_events": self._dropped}}
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
