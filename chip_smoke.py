#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
with nvcc, holds each kernel against its plain PyTorch version on the
card, then runs the port's serving path for qwen3-1.7b at full width
(28 layers, d_model 2048, vocab 151 936, random weights from a seed):
save the bf16 weights to scda and restore them bit-exactly, one prefill
of 4 × 512 tokens, and 4 requests served token by token (a 64-token
prompt, then 32 greedy tokens) through the K1 flash-attention kernel.
Every phase asserts; any failure exits non-zero.  The line before the
last is a JSON object with each kernel's launches, error and times; the
last line is ``{"ok": true, "device": {...}}``.  No fallback: without a
GPU, or outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
ARCH = "qwen3-1.7b"
SEED = 0
PREFILL_B, PREFILL_S = 4, 512
SERVE_B, MAX_LEN, PROMPT_LEN, GEN_LEN = 4, 1024, 64, 32
DECODE_OFFSETS = (63, 95, 511, 1023)

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

#: kernel vs plain version on the same inputs.  f32: the reference's own
#: kernel tolerance (tests/test_kernels.py TOL).  bf16: the same, as the
#: kernel rounds p to bf16 per 64-key tile and the plain version per
#: 512-key chunk, and the outputs are rounded to bf16 (2^-8 relative).
TOL_F32 = dict(rtol=2e-5, atol=2e-5)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
#: Full-model logits in bf16 (28 layers, bf16 residual stream), between
#: paths whose matmuls round at different shapes: decode vs prefill, and
#: the kernel vs the plain attention.
TOL_LOGITS = dict(rtol=5e-2, atol=1e-1)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time of one ``fn()`` on the card's timeline, launch gaps
    included (CUDA events around ``iters`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of the kernels one ``fn()`` launches (the sum of
    their durations in a ``torch.profiler`` CUDA trace): what the card
    spends, without the host's launch overhead."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in device_rows(prof))
    check(total_us > 0, "the profiler recorded no device time")
    return total_us / 1e3 / iters


def device_rows(prof):
    """The profile's rows that are device activity (kernels, copies,
    sets); operator rows are left out, as their device time repeats their
    kernels'."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def timings(kernel, plain, library, iters: int):
    """Device and per-call times of the kernel, its plain version and the
    library yardstick on the same inputs."""
    few = max(2, iters // 10)
    return dict(ms=device_time_ms(kernel, iters),
                plain_ms=device_time_ms(plain, few),
                library_ms=device_time_ms(library, iters),
                call_ms=cuda_time_ms(kernel, iters),
                plain_call_ms=cuda_time_ms(plain, few),
                library_call_ms=cuda_time_ms(library, iters))


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def assert_close(a, b, tol, what: str) -> float:
    import torch
    err = max_err(a, b)
    ok = torch.allclose(a.float(), b.float(), **tol)
    check(ok, f"{what}: max abs err {err} exceeds {tol}")
    return err


# ---------------------------------------------------------------- phase 2 --
def kernel_checks(torch, fa):
    """K1 against its plain version: small f32 cases, then the main path's
    bf16 shapes with times.  Returns the per-shape measurement records."""
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(SEED)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=cuda,
                           dtype=torch.float32).to(dtype)

    off = lambda v: torch.tensor(v, dtype=torch.int32, device=cuda)  # noqa
    # (B, H, Hkv, Sq, Skv, D, causal, window, q_offset)
    small = [
        (1, 2, 1, 37, 37, 64, True, None, 0),       # ragged Skv
        (2, 8, 2, 70, 70, 128, True, None, 0),      # GQA group 4
        (1, 16, 1, 9, 9, 128, True, None, 0),       # group 16
        (1, 4, 2, 20, 100, 32, False, None, 0),     # non-causal, Sq != Skv
        (1, 4, 4, 130, 130, 64, True, 16, 0),       # sliding window
        (2, 4, 2, 5, 40, 128, True, None, 30),      # q_offset > 0 (host int)
        (2, 4, 2, 5, 40, 128, True, None, off(30)),  # q_offset on device
        (3, 4, 2, 1, 300, 16, True, 64, off(157)),  # decode Sq = 1, window
        (1, 2, 1, 8, 8, 64, True, 0, 0),            # empty window: all zero
    ]
    worst = 0.0
    for B, H, Hkv, Sq, Skv, D, causal, window, q_off in small:
        q = rand(B, Sq, H, D, dtype=torch.float32)
        k = rand(B, Skv, Hkv, D, dtype=torch.float32)
        v = rand(B, Skv, Hkv, D, dtype=torch.float32)
        kw = dict(causal=causal, window=window, q_offset=q_off)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        worst = max(worst, assert_close(
            got, want, TOL_F32,
            f"K1 f32 B{B} H{H}/{Hkv} Sq{Sq} Skv{Skv} D{D} {kw}"))
    print(f"K1 f32 cases: {len(small)} pass, max abs err {worst}")

    bf16 = torch.bfloat16
    H, Hkv, D = 16, 8, 128
    records = []

    # prefill B=4, S=512: causal self-attention in the model's layout
    q = rand(PREFILL_B, PREFILL_S, H, D, dtype=bf16)
    k = rand(PREFILL_B, PREFILL_S, Hkv, D, dtype=bf16)
    v = rand(PREFILL_B, PREFILL_S, Hkv, D, dtype=bf16)
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    err = assert_close(got, want, TOL_BF16, "K1 bf16 prefill")
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = sdpa_gqa(torch)
    lib = sdpa(qh, kh, vh, is_causal=True)
    check(torch.allclose(lib.transpose(1, 2).float(), got.float(),
                         **TOL_BF16), "SDPA yardstick disagrees (prefill)")
    S = PREFILL_S
    flops = 4 * PREFILL_B * H * D * (S * (S + 1) // 2)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
    records.append(dict(
        shape=f"prefill B{PREFILL_B} S{S} H{H}/{Hkv} D{D} causal bf16",
        max_abs_err=err,
        **timings(lambda: fa.flash_attention_cuda(q, k, v),
                  lambda: fa.flash_attention_plain(q, k, v),
                  lambda: sdpa(qh, kh, vh, is_causal=True), 50),
        **bound(nbytes, flops, PEAK_BF16_FLOPS)))

    # decode: Sq = 1 against an S_max = 1024 cache at several offsets.  The
    # caches rotate over enough copies (> 50 MB L2) to be read cold, as a
    # layer's cache is in the model's step.
    copies = 16
    caches = [(rand(SERVE_B, MAX_LEN, Hkv, D, dtype=bf16),
               rand(SERVE_B, MAX_LEN, Hkv, D, dtype=bf16))
              for _ in range(copies)]
    qd = rand(SERVE_B, 1, H, D, dtype=bf16)
    for pos in DECODE_OFFSETS:
        p = off(pos)
        kc, vc = caches[0]
        got = fa.flash_attention_cuda(qd, kc, vc, q_offset=p)
        want = fa.flash_attention_plain(qd, kc, vc, q_offset=p)
        err = assert_close(got, want, TOL_BF16, f"K1 bf16 decode pos {pos}")
        lib = sdpa(qd.transpose(1, 2), kc[:, :pos + 1].transpose(1, 2),
                   vc[:, :pos + 1].transpose(1, 2))
        check(torch.allclose(lib.transpose(1, 2).float(), got.float(),
                             **TOL_BF16), f"SDPA disagrees (decode {pos})")
        it = iter(range(1 << 30))

        def kern():
            kc_, vc_ = caches[next(it) % copies]
            fa.flash_attention_cuda(qd, kc_, vc_, q_offset=p)

        def plain():
            kc_, vc_ = caches[next(it) % copies]
            fa.flash_attention_plain(qd, kc_, vc_, q_offset=p)

        def library():
            kc_, vc_ = caches[next(it) % copies]
            sdpa(qd.transpose(1, 2), kc_[:, :pos + 1].transpose(1, 2),
                 vc_[:, :pos + 1].transpose(1, 2))

        live = pos + 1
        flops = 4 * SERVE_B * H * D * live
        nbytes = 2 * (2 * qd.numel() + 2 * SERVE_B * live * Hkv * D)
        records.append(dict(
            shape=f"decode B{SERVE_B} Smax{MAX_LEN} pos{pos} H{H}/{Hkv} "
                  f"D{D} bf16",
            max_abs_err=err, **timings(kern, plain, library, 200),
            **bound(nbytes, flops, PEAK_BF16_FLOPS)))
    for r in records:
        print(f"K1 {r['shape']}: err {r['max_abs_err']} device ms "
              f"{r['ms']:.5f} plain {r['plain_ms']:.5f} sdpa "
              f"{r['library_ms']:.5f} bound {r['bound_ms']:.5f} "
              f"({r['bound_by']}); per call ms {r['call_ms']:.5f} plain "
              f"{r['plain_call_ms']:.5f} sdpa {r['library_call_ms']:.5f}")
    return records


def sdpa_gqa(torch):
    """PyTorch's fused attention with grouped kv heads: the timing
    yardstick only (the port never calls it).  Before torch 2.5 it has no
    ``enable_gqa``; there the kv heads are repeated inside the call."""
    f = torch.nn.functional.scaled_dot_product_attention
    if tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5):
        return lambda q, k, v, **kw: f(q, k, v, enable_gqa=True, **kw)

    def repeated(q, k, v, **kw):
        rep = q.shape[1] // k.shape[1]
        return f(q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1),
                 **kw)
    return repeated


def bound(nbytes: int, flops: int, peak_flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


# ---------------------------------------------------------------- phase 3 --
def checkpoint_phase(torch, cfg, tmp):
    from repro_torch.checkpoint import save
    from repro_torch.models import cast_params, init_lm, param_bytes
    from repro_torch.serve import load_weights
    cuda = torch.device("cuda")
    params = cast_params(init_lm(cfg, SEED, device=cuda), torch.bfloat16)
    torch.cuda.synchronize()
    nbytes = param_bytes(params)
    path = os.path.join(tmp, "qwen3-1.7b-bf16.scda")
    t0 = time.perf_counter()
    save(path, params, step=1000)
    t_save = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    weights, step = load_weights(cfg, path, like=params, device=cuda)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    check(step == 1000, f"restored step {step}")

    def leaves(tree, prefix=""):
        for k_, v_ in sorted(tree.items()):
            if isinstance(v_, dict):
                yield from leaves(v_, f"{prefix}{k_}/")
            else:
                yield f"{prefix}{k_}", v_

    got = dict(leaves(weights))
    n = 0
    for name, want in leaves(params):
        t = got[name]
        check(t.device.type == "cuda" and t.dtype == want.dtype
              and t.shape == want.shape, f"leaf {name}: {t.dtype} "
              f"{tuple(t.shape)} on {t.device}")
        check(torch.equal(t.view(torch.int16), want.view(torch.int16)),
              f"leaf {name} is not bit-equal after restore")
        n += 1
    os.remove(path)
    print(f"checkpoint: {n} leaves bit-equal, {nbytes} B of weights, file "
          f"{size} B, save {size / t_save / 1e6:.1f} MB/s ({t_save:.3f} s), "
          f"restore {size / t_restore / 1e6:.1f} MB/s ({t_restore:.3f} s)")
    del params
    return weights


# ------------------------------------------------------------ phases 4, 5 --
def prefill_phase(torch, cfg, weights, k1):
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.train.step import make_prefill_step
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                           generator=gen, device=cuda, dtype=torch.int32)
    prefill = make_prefill_step(cfg)
    before = k1.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = prefill(weights, {"tokens": tokens})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(k1.launches - before == cfg.n_layers,
          f"prefill launched K1 {k1.launches - before} times, expected "
          f"{cfg.n_layers}")
    check(tuple(logits.shape) == (PREFILL_B, cfg.vocab)
          and bool(torch.isfinite(logits).all()), "prefill logits")
    with mock.patch.object(ops, "flash_attention",
                           _plain_attention(fa_mod)):
        plain = prefill(weights, {"tokens": tokens})
    err = assert_close(logits, plain, TOL_LOGITS,
                       "prefill logits, kernel vs plain attention")
    print(f"prefill: B{PREFILL_B} S{PREFILL_S} in {dt * 1e3:.3f} ms "
          f"(first call), {cfg.n_layers} K1 launches, logits vs plain "
          f"attention max abs err {err}")


def _plain_attention(fa_mod):
    def plain(q, k, v, *, causal=True, window=None, kv_chunk=512,
              q_offset=0):
        return fa_mod.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, kv_chunk=kv_chunk,
                                            q_offset=q_offset)
    return plain


def serve_phase(torch, cfg, weights, k1):
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.serve import generate
    from repro_torch.train.step import make_prefill_step, make_serve_step
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(SEED + 2)
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, PROMPT_LEN),
                            generator=gen, device=cuda, dtype=torch.int32)
    events, kept, counts = [], {}, []

    def on_step(i, logits):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        counts.append(k1.launches)
        if PROMPT_LEN - 1 <= i < PROMPT_LEN + 4:
            kept[i] = logits.clone()

    torch.cuda.reset_peak_memory_stats()
    before = k1.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(cfg, weights, prompts, GEN_LEN, max_len=MAX_LEN,
                   on_step=on_step)
    tokens = out["tokens"].cpu()
    t_total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = PROMPT_LEN + GEN_LEN
    per_step = [b - a for a, b in zip([before] + counts[:-1], counts)]
    check(per_step == [cfg.n_layers] * steps,
          f"K1 launches per step {sorted(set(per_step))}, expected "
          f"{cfg.n_layers}")
    check(int(out["cache"]["pos"]) == steps, "cache position")
    check(tuple(tokens.shape) == (SERVE_B, GEN_LEN)
          and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab,
          "generated tokens")
    decode_ms = events[PROMPT_LEN - 1].elapsed_time(events[-1]) / GEN_LEN
    # per decode step: its median, and the highest percentile with ten
    # samples above it
    durations = sorted(a.elapsed_time(b) for a, b in
                       zip(events[PROMPT_LEN - 1:-1], events[PROMPT_LEN:]))
    step_p50 = durations[len(durations) // 2]
    step_hi = durations[len(durations) - 11]
    prompt_ms = events[0].elapsed_time(events[PROMPT_LEN - 1]) / (
        PROMPT_LEN - 1)

    # the logits after the prompt equal a prefill of the same 64 tokens
    pre = make_prefill_step(cfg)(weights, {"tokens": prompts})
    err_pre = assert_close(out["prompt_logits"], pre, TOL_LOGITS,
                           "serve logits after the prompt vs prefill")

    # the plain attention path, fed the same tokens, gives the same logits
    step_fn = make_serve_step(cfg)
    from repro_torch.models import init_cache
    cache = init_cache(cfg, SERVE_B, MAX_LEN, device=cuda)
    seq = torch.cat([prompts, out["tokens"][:, :4].to(cuda)], dim=1)
    err_plain = 0.0
    with mock.patch.object(ops, "flash_attention",
                           _plain_attention(fa_mod)):
        for i in range(PROMPT_LEN + 4):
            logits, cache = step_fn(weights, cache, seq[:, i:i + 1])
            if i in kept:
                err_plain = max(err_plain, assert_close(
                    kept[i], logits, TOL_LOGITS,
                    f"step {i} logits, kernel vs plain attention"))
    tok_s = SERVE_B * GEN_LEN / (decode_ms * GEN_LEN / 1e3)
    print(f"serve: {SERVE_B} requests, prompt {PROMPT_LEN}, {GEN_LEN} "
          f"greedy tokens, max_len {MAX_LEN}: {decode_ms:.4f} ms/decode "
          f"step, {prompt_ms:.4f} ms/prompt step, {tok_s:.1f} tokens/s, "
          f"total {t_total:.3f} s, peak memory {peak} B, {cfg.n_layers} K1 "
          f"launches per step")
    print(f"serve: logits after prompt vs prefill max abs err {err_pre}; "
          f"kernel vs plain attention over the prompt's last step and 4 "
          f"decode steps max abs err {err_plain}")
    for b in range(SERVE_B):
        print(f"  req{b}: {tokens[b, :12].tolist()}...")
    print(f"serve: decode step median {step_p50:.4f} ms, p"
          f"{100 * (len(durations) - 10) // len(durations)} {step_hi:.4f} "
          f"ms over {len(durations)} steps")
    return dict(decode_ms=decode_ms, decode_step_p50_ms=step_p50,
                decode_step_hi_ms=step_hi, prompt_step_ms=prompt_ms,
                tokens_per_s=tok_s, peak_bytes=peak), out


def decode_breakdown(torch, cfg, weights, out, steps: int = 4):
    """Where a decode step's time goes: ``steps`` more greedy steps on the
    served cache under the profiler — wall time per step, device busy
    time per step, K1's share and the heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.step import make_serve_step
    step_fn = make_serve_step(cfg)
    cache = out["cache"]
    tok = out["tokens"][:, -1:].to(torch.int32)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(steps):
            logits, cache = step_fn(weights, cache, tok)
            tok = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / steps
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
            for e in device_rows(prof)]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    k1 = sum(r[1] for r in rows if "flash_fwd_kernel" in r[0])
    print(f"decode step breakdown (profiled, {steps} steps): wall "
          f"{wall:.4f} ms/step, device busy {busy:.4f} ms/step (idle share "
          f"{1 - busy / wall:.4f}), K1 {k1:.4f} ms/step")
    for name, ms, n in rows[:8]:
        print(f"  {ms:.4f} ms/step  x{n}  {name[:90]}")
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                k1_ms=k1, top=[dict(kernel=r[0][:120], ms=r[1], calls=r[2])
                               for r in rows[:8]])


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from the root of a repro checkout "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke test runs only on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi_line())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    sys.stdout.flush()

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    build.load(fa.SOURCE)
    seconds, log = build.build_report(fa.SOURCE)
    print(f"built {fa.SOURCE} in {seconds:.2f} s "
          f"({time.perf_counter() - t0:.2f} s with load)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")

    records = kernel_checks(torch, fa)

    cfg = get_config(ARCH)
    tmp = tempfile.mkdtemp(prefix="repro-torch-smoke-")
    try:
        with torch.inference_mode():
            weights = checkpoint_phase(torch, cfg, tmp)
            fa.flash_attention_cuda.launches = 0   # the main path starts
            prefill_phase(torch, cfg, weights, fa.flash_attention_cuda)
            serve, out = serve_phase(torch, cfg, weights,
                                     fa.flash_attention_cuda)
            launches = fa.flash_attention_cuda.launches  # ...and ends
            serve["breakdown"] = decode_breakdown(torch, cfg, weights, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    expected = cfg.n_layers * (1 + 1 + PROMPT_LEN + GEN_LEN)
    check(launches == expected, f"main path launched K1 {launches} times, "
          f"expected {expected}")

    head = records[0]
    kernels = [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:82",
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in records),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        shapes=records, serve=serve)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
