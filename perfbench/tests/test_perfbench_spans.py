"""The readers of the program's own spans (``lib/spans.py`` and the five
``metrics/*_share.*`` that read it) on a made-up collector with known
device intervals: their values, the rule that a window counts its last
``len(work)`` root spans, None without device intervals or spans, and
the five entries in ``BENCHMARK.json``."""
import pytest

from perfbench.lib import cell as cell_mod
from perfbench.lib import trace as ptrace
from perfbench.run import Context
from repro_torch.core import trace

BENCH = cell_mod.load_benchmark()
TRAIN = "falcon-mamba-7b.train_4k"
PREFILL = "falcon-mamba-7b.prefill_32k"
NEW = {"optimizer_share.train": TRAIN, "head_share.train": TRAIN,
       "recompute_share.train": TRAIN, "m1_eager_share.prefill": PREFILL,
       "outside_step_share.prefill": PREFILL}
MS = 1_000_000      # ns


class Spans:
    """A made-up collector: spans opened and closed at given device
    times (ms), each under the span open when it starts."""

    def __init__(self, device=True):
        self.records, self.stack, self.device = [], [], device

    def span(self, key, t0, t1, **args):
        cat, name = key.split(".", 1)
        parent = self.stack[-1] if self.stack else None
        sid = len(self.records) + 1
        dev = (t0 * MS, t1 * MS) if self.device else (None, None)
        rec = trace.SpanRecord(
            name, cat, sid, None if parent is None else parent.id,
            sid if parent is None else parent.root, 1, t0 * MS, t1 * MS,
            0 if self.device else None, *dev, args)
        self.records.append(rec)
        return _Open(self, rec)

    def spans(self):
        return sorted(self.records, key=lambda r: r.host_start_ns)


class _Open:
    def __init__(self, owner, rec):
        self.owner, self.rec = owner, rec

    def __enter__(self):
        self.owner.stack.append(self.rec)

    def __exit__(self, *exc):
        self.owner.stack.pop()


def train_step(c, t):
    """One train step at ``t`` ms, 100 ms long: forward 30 (the head's
    10 of it), backward 60 (a layer's 40 with its recompute 15, the
    head's 15 with a chunk's recompute 5), the optimizer 10."""
    with c.span("step.train", t, t + 100):
        with c.span("step.forward", t, t + 30):
            c.span("model.layer", t, t + 20, recompute=False)
            with c.span("model.loss_head", t + 20, t + 30, recompute=False):
                c.span("model.loss_chunk", t + 20, t + 30, recompute=False)
        with c.span("step.backward", t + 30, t + 90):
            with c.span("model.loss_head.bwd", t + 30, t + 45):
                c.span("model.loss_chunk", t + 30, t + 35, recompute=True)
            with c.span("model.layer.bwd", t + 45, t + 85):
                with c.span("model.layer", t + 45, t + 60, recompute=True):
                    # nested under a recompute: not counted again
                    c.span("model.cast", t + 45, t + 50, recompute=True)
                c.span("kernel.k2_bwd", t + 60, t + 85)
        c.span("step.optimizer", t + 90, t + 100, recompute=False)


def prefill_request(c, t, ms):
    """One request at ``t`` ms, ``ms`` long: conv, dt and gate a tenth
    of it each, the scan the rest but for the head."""
    with c.span("step.prefill", t, t + ms, B=1, S=4096):
        with c.span("model.layer", t, t + 0.9 * ms, recompute=False):
            c.span("ssm.conv", t, t + 0.1 * ms)
            c.span("ssm.dt", t + 0.1 * ms, t + 0.2 * ms)
            c.span("ssm.scan", t + 0.2 * ms, t + 0.8 * ms)
            c.span("ssm.gate", t + 0.8 * ms, t + 0.9 * ms)
        c.span("model.head", t + 0.9 * ms, t + ms)


def _ctx(workload, kind, work, window_s=1.0):
    tr = ptrace.Trace(window_s=window_s, busy_s=window_s, kernels={},
                      gaps={})
    return Context(cell=cell_mod.resolve(BENCH, workload), kind=kind,
                   work=work, trace=tr, spans={}, window_peak=0)


def _read(name, ctx):
    return ctx.cell.reader(name)(ctx)


@pytest.fixture
def collector(monkeypatch):
    holder = {}
    monkeypatch.setattr(trace, "collector", lambda: holder.get("c"))
    return holder


def test_train_readers(collector):
    c = collector["c"] = Spans()
    # an earlier profile's step that the window does not count: its
    # optimizer took the whole step
    with c.span("step.train", 0, 100):
        c.span("step.optimizer", 0, 100)
    train_step(c, 1000)
    train_step(c, 2000)
    ctx = _ctx(TRAIN, "train", [{"B": 16, "S": 4096}] * 2)
    assert _read("optimizer_share.train", ctx) == pytest.approx(10.0)
    assert _read("head_share.train", ctx) == pytest.approx(25.0)
    # the layer's recompute 15 and the chunk's 5, the cast inside not
    # again
    assert _read("recompute_share.train", ctx) == pytest.approx(20.0)
    # with one step of work, the last root alone
    one = _ctx(TRAIN, "train", [{"B": 16, "S": 4096}])
    assert _read("optimizer_share.train", one) == pytest.approx(10.0)
    # three steps of work over three roots: the first one counts too
    three = _ctx(TRAIN, "train", [{"B": 16, "S": 4096}] * 3)
    assert _read("optimizer_share.train", three) == pytest.approx(
        100 * (100 + 10 + 10) / 300)
    assert _read("m1_eager_share.prefill", ctx) is None   # another kind


def test_prefill_readers(collector):
    c = collector["c"] = Spans()
    prefill_request(c, 0, 100)
    prefill_request(c, 200, 300)
    ctx = _ctx(PREFILL, "prefill", [{"B": 1, "S": 4096}] * 2,
               window_s=0.5)
    assert _read("m1_eager_share.prefill", ctx) == pytest.approx(30.0)
    # 400 ms of steps in a 500 ms window
    assert _read("outside_step_share.prefill", ctx) == pytest.approx(20.0)
    last = _ctx(PREFILL, "prefill", [{"B": 1, "S": 4096}], window_s=0.5)
    assert _read("outside_step_share.prefill", last) == pytest.approx(40.0)


def test_readers_are_silent_without_device_intervals_or_spans(collector):
    cells = {TRAIN: ("train", train_step),
             PREFILL: ("prefill", lambda c, t: prefill_request(c, t, 100))}
    for name, workload in NEW.items():
        kind, make = cells[workload]
        ctx = _ctx(workload, kind, [{"B": 1, "S": 4096}])
        collector.pop("c", None)
        assert _read(name, ctx) is None           # no collector
        collector["c"] = Spans()
        assert _read(name, ctx) is None           # no root spans
        collector["c"] = c = Spans(device=False)
        make(c, 0)
        assert _read(name, ctx) is None           # host intervals alone
        collector["c"] = c = Spans()
        make(c, 0)
        assert _read(name, ctx) is not None
        # more work than root spans: silent rather than partial
        more = _ctx(workload, kind, [{"B": 1, "S": 4096}] * 2)
        assert _read(name, more) is None


def test_the_five_entries():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert list(per_layer)[-5:] == list(NEW)
    for name, workload in NEW.items():
        m = per_layer[name]
        assert m["unit"] == "%" and m["better"] == "lower"
        assert m["source"] == "program_span"
        assert m["workloads"] == [workload]
        assert workload in e2e[m["moves"]]["workloads"]
        cell = cell_mod.resolve(BENCH, workload)
        assert name in [p["name"] for p in cell.per_layer]
        assert callable(cell.reader(name))
