"""The trace's reduction and the per-layer metrics' readers, on a made-up
profile (the real one comes only from a run on the card)."""
import pytest

from perfbench.counts import kernels as kc
from perfbench.lib import cell as cell_mod
from perfbench.lib import trace
from perfbench.run import Context

BENCH = cell_mod.load_benchmark()


def ev(name, start, end, on_device=True, marked=False):
    return trace.Event(name, on_device, start, end, 1, marked)


EVENTS = [
    ev(trace.WINDOW_NAME, 0, 1000, False, True),
    ev(trace.WINDOW_NAME, 0, 1000, True, True),   # its range on the device
    ev("aten::mm", 0, 120, False),
    ev("cudaLaunchKernel", 100, 110, False),
    ev("aten::exp", 300, 700, False),
    ev("void ssm_scan_fused_kernel<__nv_bfloat16, 16>(Params)", 120, 320),
    ev("sm90_xmma_gemm_bf16bf16_bf16f32", 310, 400),   # overlaps the last
    ev("void at::native::vectorized_elementwise_kernel<4>", 600, 900),
    ev("Memcpy DtoH (Device -> Pinned)", 900, 950),
    ev("void flash_prefill_kernel<80, false>(FlashParams)", 990, 1100),
]


def test_busy_kernels_and_gaps():
    tr = trace.reduce(EVENTS, window_s=1e-3)
    # device intervals inside [0, 1000]: 120-400, 600-950, 990-1000
    assert tr.busy_s == pytest.approx((280 + 350 + 10) * 1e-6)
    assert tr.kernels["Memcpy DtoH (Device -> Pinned)"] == \
        pytest.approx((50e-6, 1))
    # gaps: 0-120 (aten::mm), 400-600 (aten::exp), 950-990 (nothing)
    assert tr.gaps["aten::mm"] == pytest.approx(120e-6)
    assert tr.gaps["aten::exp"] == pytest.approx(200e-6)
    assert tr.gaps["host (no event)"] == pytest.approx(40e-6)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0].startswith("void at::native")
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def _ctx(workload, kind, work):
    tr = trace.reduce(EVENTS, window_s=1e-3)
    return Context(cell=cell_mod.resolve(BENCH, workload), kind=kind,
                   work=work, trace=tr, window_peak=3 * 2**30,
                   spans={"save_s": 2.0, "restore_s": 1.0,
                          "file_bytes": 2 * 10**9})


def test_readers_of_a_prefill_cell():
    ctx = _ctx("falcon-mamba-7b.prefill_32k", "prefill", [{"B": 1, "S": 64}])
    read = {m["name"]: ctx.cell.reader(m["name"])(ctx)
            for m in ctx.cell.per_layer}
    assert read["save_GBps"] == pytest.approx(1.0)
    assert read["restore_GBps"] == pytest.approx(2.0)
    assert read["peak_mem_gib.prefill"] == pytest.approx(3.0)
    assert read["idle_share.prefill"] == pytest.approx(36.0)
    # eager: the elementwise kernel alone, 300 of 640 busy microseconds
    assert read["eager_share.prefill"] == pytest.approx(100 * 300 / 640)
    want = 8 * kc.k2_fused_s(1, 64, 8192, 16, states=False) / 200e-6
    assert read["k2_roofline.prefill"] == pytest.approx(100 * want)
    assert read["mfu.prefill"] > 0


def test_a_profile_read_from_kineto():
    """The rows of a real (host-only) profile: the window and its ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW_NAME):
            torch.ones(64, 64) @ torch.ones(64, 64)
    rows = trace.events_of(prof)
    assert any(r.name == trace.WINDOW_NAME and r.marked for r in rows)
    assert any(r.name == "aten::mm" and not r.on_device for r in rows)
    tr = trace.reduce(rows, window_s=1.0)
    assert tr.busy_s == 0 and tr.kernels == {}


def test_a_kernel_that_did_not_run_leaves_its_roofline_silent():
    ctx = _ctx("falcon-mamba-7b.train_4k", "train", [{"B": 2, "S": 64}])
    read = ctx.cell.reader("k2_roofline.train")
    events = [e for e in EVENTS if "ssm_scan" not in e.name]
    ctx.trace = trace.reduce(events, window_s=1e-3)
    assert read(ctx) is None
