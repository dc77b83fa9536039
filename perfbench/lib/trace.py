"""The traced window: ``torch.profiler`` around a fixed amount of the
cell's work, and its reduction to what the per-layer metrics read.

The device rows (kernels, copies, sets) of the profile give the busy time
(the union of their intervals inside the window), each kernel's device
time by name, and the idle gaps between them, each named by the
innermost host event that covers its start.  The window sits
``PAD_S`` inside each end of the profile: a profile whose ends have no
host idle may lose the card's first events (the clock conversion is now
and then off by milliseconds), and one that recorded no device time is
taken again, up to ``TRIES`` times.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Tuple

PAD_S = 0.02
TRIES = 3
WINDOW_NAME = "perfbench.window"
#: Gaps shorter than this are counted in the idle time but not named.
NAMED_GAP_US = 5.0


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    #: kernel (or copy) name -> (device seconds, launches)
    kernels: Dict[str, Tuple[float, int]]
    #: what the host was doing -> seconds of device idle
    gaps: Dict[str, float]

    def time_of(self, match: Callable[[str], bool]) -> float:
        return sum(s for name, (s, _) in self.kernels.items() if match(name))

    def breakdown(self, n: int = 10) -> Dict[str, List]:
        ops = sorted(((k, s) for k, (s, _) in self.kernels.items()),
                     key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, s] for k, s in ops],
                "idle_gaps": [[k, s] for k, s in gaps]}


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class Event:
    """One row of a profile: name, on the device or the host, its interval
    in microseconds, its host thread, and whether it is a range a program
    marked (``record_function``) rather than work."""
    name: str
    on_device: bool
    start: float
    end: float
    thread: int = 0
    marked: bool = False


def events_of(prof) -> List[Event]:
    """The profile's rows, read from kineto's raw results (building the
    profiler's event tree takes minutes on a window of many launches)."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        out.append(Event(e.name(), e.device_type() == DeviceType.CUDA,
                         e.start_ns() / 1e3, e.end_ns() / 1e3,
                         e.start_thread_id(), bool(e.is_user_annotation())))
    return out


def reduce(events: List[Event], window_s: float) -> Trace:
    """The profile's rows → a :class:`Trace` of the window."""
    win = [e for e in events if e.name == WINDOW_NAME and not e.on_device]
    if not win:
        raise RuntimeError("the profile holds no window range")
    w0, w1 = win[0].start, win[0].end
    dev, host = [], []
    for e in events:
        if e.marked or e.name == WINDOW_NAME:
            continue            # a range a program marked, not work
        if e.on_device:
            s, t = max(e.start, w0), min(e.end, w1)
            if t > s:
                dev.append((s, t, e.name))
        else:
            host.append((e.start, e.end, e.name, e.thread))
    kernels: Dict[str, List] = collections.defaultdict(lambda: [0.0, 0])
    for s, t, name in dev:
        kernels[name][0] += (t - s) * 1e-6
        kernels[name][1] += 1
    merged = _merge([(s, t) for s, t, _ in dev])
    busy_us = sum(t - s for s, t in merged)
    # idle gaps: before the first, between, and after the last interval
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    spans = [(g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2])
             if g1 - g0 >= NAMED_GAP_US]
    gaps: Dict[str, float] = collections.defaultdict(float)
    for (g0, g1), name in zip(spans, _doing(host, [g0 for g0, _ in spans])):
        gaps[name] += (g1 - g0) * 1e-6
    return Trace(window_s=window_s, busy_s=busy_us * 1e-6,
                 kernels={k: (v[0], v[1]) for k, v in kernels.items()},
                 gaps=dict(gaps))


def _doing(host, times: List[float]) -> List[str]:
    """For each of the sorted ``times``, the shortest host event that
    covers it, over every thread (events nest within a thread)."""
    best = [("host (no event)", float("inf"))] * len(times)
    threads = collections.defaultdict(list)
    for s, e, name, tid in host:
        threads[tid].append((s, e, name))
    for evs in threads.values():
        evs.sort()
        stack: List[Tuple[float, float, str]] = []
        j = 0
        for i, t in enumerate(times):
            while j < len(evs) and evs[j][0] <= t:
                while stack and stack[-1][1] < evs[j][0]:
                    stack.pop()
                stack.append(evs[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            if stack and stack[-1][1] - stack[-1][0] < best[i][1]:
                best[i] = (stack[-1][2], stack[-1][1] - stack[-1][0])
    return [name for name, _ in best]


def traced(work: Callable[[], object], sync: Callable[[], None]):
    """Run ``work()`` under the profiler; returns (its result, Trace).
    ``work`` runs again (a fresh profile) while the profile recorded no
    device time, up to TRIES times."""
    import sys
    from torch.profiler import ProfilerActivity, profile, record_function
    for _ in range(TRIES):
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PAD_S)
            with record_function(WINDOW_NAME):
                t0 = time.perf_counter()
                out = work()
                sync()
                window_s = time.perf_counter() - t0
            time.sleep(PAD_S)
        trace = reduce(events_of(prof), window_s)
        if trace.busy_s > 0:
            return out, trace
        print("perfbench: the profile recorded no device time; taking it "
              "again", file=sys.stderr, flush=True)
    raise RuntimeError(f"the profiler recorded no device time in {TRIES} "
                       f"tries")
