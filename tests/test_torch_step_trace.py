"""The compute path's spans (``repro_torch.core.trace.compute``) on the
CPU, over a falcon-shaped Mamba1 smoke model's train and prefill steps:
the span tree (names, parents, roots, the ``recompute`` flag and the
counts a step), results bitwise equal with spans live and off, nothing
recorded and no autograd node added while off, the collector a
``torch.profiler`` window installs and the mapping of its spans onto the
profiler's clock, and the checkpoint journal's counters untouched.  The
spans' device intervals are held against the profiler on the card by
``tests/test_torch_gpu.py``."""
import collections
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.core import trace  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

CFG = smoke(get_config("falcon-mamba-7b"))
B, S, CHUNK = 2, 32, 8
N_CHUNKS = S // CHUNK
#: the Mamba1 block's spans, once a layer a forward
SSM_SPANS = ("ssm.in_proj", "ssm.conv", "ssm.x_proj", "ssm.dt", "ssm.gate",
             "ssm.out_proj", "kernel.k2_fwd")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_collector(monkeypatch):
    monkeypatch.delenv(trace.TRACE_ENV, raising=False)
    trace.uninstall()
    yield
    trace.uninstall()


def _params():
    return lm.init_lm(CFG, 0, device="cpu")


def _batch(seed=0):
    seq = torch.randint(0, CFG.vocab, (B, S + 1),
                        generator=torch.Generator().manual_seed(seed))
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def _train(n_steps=1):
    """``n_steps`` train steps from fresh weights: (params, metrics)."""
    params = _params()
    opt = adamw.init(params)
    step = tstep.make_train_step(CFG, adamw.AdamWConfig(), loss_chunk=CHUNK)
    for k in range(n_steps):
        params, opt, metrics = step(params, opt, _batch(k))
    return params, metrics


def _prefill():
    with torch.inference_mode():
        return tstep.make_prefill_step(CFG)(_params(), _batch())


def _parent_of(spans):
    by_id = {s.id: s for s in spans}
    return lambda s: by_id[s.parent].key if s.parent is not None else None


def test_train_step_span_tree():
    tc = trace.install()
    _train()
    spans = tc.spans()
    parent = _parent_of(spans)
    (root,) = [s for s in spans if s.parent is None]
    assert root.key == "step.train" and root.args["B"] == B \
        and root.args["S"] == S
    assert all(s.root == root.id for s in spans)
    assert all(s.device_start_ns is None and s.device_ns is None
               for s in spans)
    assert sorted(s.key for s in spans if s.parent == root.id) == [
        "step.backward", "step.forward", "step.optimizer"]
    count = collections.Counter(
        (s.key, s.args.get("recompute"), parent(s)) for s in spans)
    L = CFG.n_layers
    # each layer once in the forward and once in the recompute, the
    # recompute inside that layer's backward span
    assert count["model.layer", False, "step.forward"] == L
    assert count["model.layer", True, "model.layer.bwd"] == L
    assert count["model.layer.bwd", None, "step.backward"] == L
    for s in spans:
        if s.key == "model.layer" and s.args["recompute"]:
            assert {s.args["i"]} == {
                p.args["i"] for p in spans if p.id == s.parent}
    assert sorted(s.args["i"] for s in spans
                  if s.key == "model.layer.bwd") == list(range(L))
    # the per-layer cast under remat, in both runs of the layer
    assert count["model.cast", False, "model.layer"] == L
    assert count["model.cast", True, "model.layer"] == L
    for name in SSM_SPANS:
        assert count[name, False, "model.layer"] == L
        assert count[name, True, "model.layer"] == L
    # each loss chunk twice: in the head's forward and its recompute
    assert count["model.loss_head", False, "step.forward"] == 1
    assert count["model.loss_head.bwd", None, "step.backward"] == 1
    assert count["model.loss_chunk", False, "model.loss_head"] == N_CHUNKS
    assert count["model.loss_chunk", True, "model.loss_head.bwd"] \
        == N_CHUNKS
    for flag in (False, True):
        assert sorted(s.args["chunk"] for s in spans
                      if s.key == "model.loss_chunk"
                      and s.args["recompute"] is flag) == list(
                          range(N_CHUNKS))
    assert count["model.embed", False, "step.forward"] == 1
    assert count["model.norm", False, "step.forward"] == 1     # the final
    assert count["model.norm", False, "model.layer"] == L
    assert count["model.norm", True, "model.layer"] == L
    # the forward's spans nest in time within their parents
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.host_start_ns <= s.host_start_ns <= s.host_end_ns \
                <= p.host_end_ns


def test_spans_count_the_same_in_every_step():
    tc = trace.install()
    _train(2)
    spans = tc.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.key for s in roots] == ["step.train"] * 2
    per_root = collections.Counter((s.root, s.key) for s in spans)
    for key in {s.key for s in spans}:
        assert per_root[roots[0].id, key] == per_root[roots[1].id, key]
    # the steps' spans are all their records: no counter, no metric
    assert not [e for e in tc.chrome()["traceEvents"] if e["ph"] == "C"]
    assert not tc.metrics.snapshot()["counters"]


def test_an_uninstalled_collector_is_freed_at_once():
    """Closed spans hold no pointer back to their collector, so one that
    is uninstalled goes with its last reference, not at a later full
    garbage collection (which would stall whatever runs then)."""
    import gc
    import weakref
    tc = trace.install()
    _train()
    assert tc.spans()
    ref = weakref.ref(tc)
    trace.uninstall()
    del tc
    gc.disable()
    try:
        assert ref() is None
    finally:
        gc.enable()


def test_the_decode_path_opens_no_span():
    params = lm.init_lm(CFG, 0, device="cpu")
    tc = trace.install()
    with torch.inference_mode():
        cache = lm.init_cache(CFG, 1, 8, device="cpu")
        lm.serve_step(CFG, params, cache, torch.zeros(
            (1, 1), dtype=torch.long))
    assert tc.spans() == []


def test_prefill_step_span_tree():
    tc = trace.install()
    _prefill()
    spans = tc.spans()
    parent = _parent_of(spans)
    (root,) = [s for s in spans if s.parent is None]
    assert root.key == "step.prefill" and root.args["S"] == S
    count = collections.Counter((s.key, parent(s)) for s in spans)
    L = CFG.n_layers
    assert count["model.embed", "step.prefill"] == 1
    assert count["model.layer", "step.prefill"] == L
    assert count["model.norm", "step.prefill"] == 1
    assert count["model.head", "step.prefill"] == 1
    for name in SSM_SPANS:
        assert count[name, "model.layer"] == L
    assert not any(s.args.get("recompute") for s in spans)
    assert not any(s.key.endswith(".bwd") or s.key == "model.cast"
                   for s in spans)


def test_results_are_bitwise_equal_with_spans_live_and_off():
    def run():
        params = _params()
        named = dict(lm_flat(params))
        for t in named.values():
            t.requires_grad_(True)
        batch = _batch()
        loss = lm.lm_loss(CFG, params, batch["tokens"], batch["labels"],
                          loss_chunk=CHUNK)
        grads = torch.autograd.grad(loss, list(named.values()))
        new, metrics = _train(2)
        return (loss.detach(), grads, dict(lm_flat(new)), metrics,
                _prefill())

    off = run()
    trace.install()
    live = run()
    assert trace.collector().spans()
    assert torch.equal(off[0], live[0])
    for a, b in zip(off[1], live[1]):
        assert torch.equal(a, b)
    assert off[2].keys() == live[2].keys()
    for k in off[2]:
        assert torch.equal(off[2][k], live[2][k]), k
    for k in off[3]:
        assert torch.equal(off[3][k], live[3][k]), k
    assert torch.equal(off[4], live[4])


def lm_flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from lm_flat(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _graph(t):
    """Every autograd node that ``t`` reaches."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        todo.extend(n for n, _ in f.next_functions)
    return seen


def _loss_graph():
    params = _params()
    for _, t in lm_flat(params):
        t.requires_grad_(True)
    batch = _batch()
    return _graph(lm.lm_loss(CFG, params, batch["tokens"], batch["labels"],
                             loss_chunk=CHUNK))


def test_off_records_nothing_and_adds_no_autograd_node():
    off = _loss_graph()
    _train()
    _prefill()
    assert trace.collector() is None and trace.live() is None
    names = collections.Counter(type(f).__name__ for f in off)
    assert not any("BackwardSpan" in n for n in names)
    trace.install()
    live = _loss_graph()
    marks = collections.Counter(type(f).__name__ for f in live
                                if "BackwardSpan" in type(f).__name__)
    # two marks a checkpointed layer and two at the loss head
    assert sum(marks.values()) == 2 * (CFG.n_layers + 1)
    assert len(live) - len(off) == 2 * (CFG.n_layers + 1)


#: Run alone in a fresh interpreter: tracemalloc counts every thread's
#: allocations, and threads that earlier tests leave behind allocate.
_ALLOCATION_CHECK = """
import contextlib, tracemalloc
import torch
from repro_torch.core import trace
NOTHING = contextlib.nullcontext()

def spans(n):
    for _ in range(n):
        with trace.compute("layer", "model") as span:
            if span:
                span.add(i=1)

def loop(n):
    # a with-block binds its manager's __exit__ for any manager
    for _ in range(n):
        with NOTHING:
            pass

def peak(fn, n):
    # the most memory fn(n) held at once, in bytes
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        fn(n)
        current, top = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert current == before, (current, before)
    return top - before

assert trace.collector() is None
spans(10)                       # binds the profiler's flag
# what a with-block and the loop's counter hold is all either holds
assert peak(spans, 1000) == peak(loop, 1000)
assert peak(spans, 1) == peak(loop, 1)
print("ok")
"""


def test_an_off_span_allocates_nothing():
    env = {k: v for k, v in os.environ.items() if k != trace.TRACE_ENV}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, "-c", _ALLOCATION_CHECK], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.split() == ["ok"], out.stderr


def _rows(prof, names):
    """(start, end) ns of the profile's rows named any of ``names``."""
    rows = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            rows[e.name()].append((e.start_ns(), e.end_ns()))
    return rows


def test_a_profiler_window_installs_a_collector_and_shares_its_clock():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        _prefill()
    c = trace.collector()
    assert c is not None and c.profiler_only
    assert [s.key for s in c.spans() if s.parent is None] == ["step.prefill"]
    # outside a window the profiler's collector records nothing
    assert trace.live() is None
    n = len(c.spans())
    _prefill()
    assert len(c.spans()) == n
    # a second window, its first calls paid: each span is a row of the
    # profile that starts where the span's host interval does
    trace.uninstall()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _prefill()
    spans = trace.collector().spans()
    rows = _rows(prof, {s.key for s in spans})
    by_key = collections.defaultdict(list)
    for s in spans:
        by_key[s.key].append(s)
    assert set(by_key) <= set(rows)
    for key, group in by_key.items():
        starts = sorted(r[0] for r in rows[key])
        assert len(starts) == len(group), key
        for s, r0 in zip(group, starts):
            assert abs(s.host_start_ns - r0) < 100_000, (key, s, r0)


def test_compute_spans_leave_the_journal_record_and_export_readable():
    tc = trace.install()
    base = tc.commit_record()
    _train()
    assert tc.commit_record() == {}
    assert not any(k.startswith(("step.", "model.", "ssm.", "kernel."))
                   for k in base)
    doc = tc.chrome()
    assert doc["baseTimeNanoseconds"] == tc._epoch_time_ns
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["cat"] for e in xs} >= {"step", "model", "ssm", "kernel"}
    assert not any(e.get("tid", 0) < 0 for e in doc["traceEvents"])
    ids = {e["args"]["id"] for e in xs}
    assert all(e["args"]["parent"] in ids | {None} for e in xs)
    summary = trace.summarize_chrome(doc["traceEvents"])
    assert summary["stages"]["step.train"]["calls"] == 1
