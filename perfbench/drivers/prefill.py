"""Prefill traffic: long prompts ingested one at a time through the port's
full-sequence prefill step, weights restored from an scda file.

Set-up makes the bf16 weights from the seed, saves them with
``repro_torch.checkpoint.save`` under ``TMPDIR`` and restores them with
``repro_torch.serve.load_weights`` (as ``python -m repro_torch.serve``
does), timing both, flushes the file's pages to the disk and deletes it
(so that no write-back of it overlaps the window), builds
``train.step.make_prefill_step`` and warms up the mix's longest prompt.
The window is a closed loop of one client: each request is one prompt of
uniform tokens at batch 1, its latency from dispatch to its last-token
logits on the host.  The prompt lengths are a fixed multiset, walked in
an order drawn from the seed and cycled; the seed changes the order and
the tokens, never the mix.

The check: the restored weights against the weights made (every element
equal), and over a sample of the finished requests drawn from the seed,
the longest among them, the widest gap by which the logit of the token
the program serves (its logits' first) lies below the reference's best.
"""
from __future__ import annotations

import gc
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
from typing import Dict, List, Tuple

import torch

from perfbench.counts.model import leaf_specs
from perfbench.lib import cell as cell_mod
from perfbench.lib import runtime, trace, weights
from perfbench.reference import model as ref
from perfbench.reference.quant import FP8


def _mix(seed: int, k: int) -> int:
    return (seed * 0x9E3779B1 + k * 0x85EBCA77 + 7) % (1 << 63)


def lengths(spec: Dict) -> List[int]:
    """The mix's fixed multiset of prompt lengths: ``count`` points spread
    evenly in log space from low to high, both ends included, each rounded
    to ``step``."""
    if spec["kind"] == "fixed":
        return list(spec["values"])
    lo, hi, step, n = spec["low"], spec["high"], spec["step"], spec["count"]
    out = []
    for i in range(n):
        x = math.exp(math.log(lo) + (math.log(hi) - math.log(lo))
                     * i / (n - 1))
        out.append(min(hi, max(lo, step * round(x / step))))
    return out


class Job:
    kind = "prefill"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        self.run = cell.run
        self.t = cell.traffic
        mix = lengths(self.t["lengths"])
        order = torch.randperm(len(mix), generator=torch.Generator()
                               .manual_seed(_mix(seed, 1)))
        self.order = [mix[i] for i in order.tolist()]
        self.done: List[Dict] = []      # finished requests of the window
        self.next = 0

    def _tokens(self, i: int, S: int) -> torch.Tensor:
        gen = torch.Generator(device=self.dev).manual_seed(_mix(self.seed,
                                                                100 + i))
        return torch.randint(0, self.run["vocab"], (1, S), generator=gen,
                             device=self.dev, dtype=torch.int32)

    def build_step(self):
        """The port's full-sequence prefill step: last-token logits."""
        from repro_torch.train.step import make_prefill_step
        return make_prefill_step(self.cfg)

    def setup(self) -> Dict[str, float]:
        from repro_torch.checkpoint import save
        from repro_torch.serve import load_weights
        self.cfg = cell_mod.port_config(self.cell.config)
        dtype = torch.bfloat16 if self.run["dtype"] == "bfloat16" \
            else torch.float32
        made = weights.make(self.run, self.seed, self.dev, dtype)
        tmp = tempfile.mkdtemp(prefix="perfbench-", dir=tempfile.gettempdir())
        path = os.path.join(tmp, "weights.scda")
        try:
            runtime.sync(self.dev)
            t0 = time.perf_counter()
            save(path, made, step=0)
            save_s = time.perf_counter() - t0
            nbytes = os.path.getsize(path)
            del made
            like = weights.nest({n: torch.empty(shape, dtype=dtype,
                                                device="meta")
                                 for n, (shape, _) in
                                 leaf_specs(self.run).items()})
            t0 = time.perf_counter()
            self.params, _ = load_weights(self.cfg, path, like,
                                          device=self.dev)
            runtime.sync(self.dev)
            restore_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            flush_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self.step_fn = self.build_step()
        # the logits land in one pinned buffer: a copy into fresh pageable
        # memory stalls the host by milliseconds a request, unevenly
        self.host_logits = torch.empty(self.run["vocab"], dtype=torch.float32,
                                       pin_memory=self.dev.type == "cuda")
        for S in self.t["warm_lengths"]:
            self._serve(self._tokens(-1, S))
        runtime.sync(self.dev)
        return {"save_s": save_s, "restore_s": restore_s,
                "flush_s": flush_s, "file_bytes": nbytes}

    def _serve(self, tokens) -> torch.Tensor:
        """The last-token logits of one prompt, on the host."""
        with torch.inference_mode():
            logits = self.step_fn(self.params, {"tokens": tokens})
            self.host_logits.copy_(logits[0])
        return self.host_logits

    def _request(self) -> Dict:
        i = self.next
        self.next += 1
        S = self.order[i % len(self.order)]
        tokens = self._tokens(i, S)
        runtime.sync(self.dev)
        t0 = time.perf_counter()
        logits = self._serve(tokens)
        latency = time.perf_counter() - t0
        rec = {"i": i, "S": S, "latency_s": latency,
               "served": int(torch.argmax(logits)),
               "finite": bool(torch.isfinite(logits).all())}
        self.done.append(rec)
        return rec

    def window(self, seconds: float) -> Tuple[Dict[str, float], int, int]:
        t0 = time.perf_counter()
        start = len(self.done)
        while True:
            self._request()
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        reqs = self.done[start:]
        lat_ms = [r["latency_s"] * 1e3 for r in reqs]
        metrics = {"prefill_tokens_per_s": sum(r["S"] for r in reqs) / elapsed,
                   "prefill_p95_ms": p95(lat_ms)}
        # where the window's time went: requests, and the host between them
        print(f"perfbench: window {elapsed:.3f} s, {len(reqs)} requests, "
              f"their latencies {sum(lat_ms) / 1e3:.3f} s, longest "
              f"{max(lat_ms):.1f} ms", file=sys.stderr)
        return metrics, len(reqs), sum(not r["finite"] for r in reqs)

    def traced_window(self, seconds: float):
        def work():
            t0 = time.perf_counter()
            out = []
            for _ in range(self.t["trace_requests"]):
                out.append({"B": 1, "S": self._request()["S"]})
                if time.perf_counter() - t0 >= seconds:
                    break
            return out
        return trace.traced(work, lambda: runtime.sync(self.dev))

    def weights_mismatch(self) -> int:
        """Elements of the restored weights that differ from those made."""
        dtype = self.params["embed"].dtype
        made = weights.make_flat(self.run, self.seed, self.dev, dtype)
        got = weights.flatten(self.params)
        if set(got) != set(made):
            return sum(t.numel() for t in made.values())
        return int(sum(int((got[n] != made[n]).sum()) for n in made))

    def release(self) -> None:
        self.mismatch = self.weights_mismatch()
        del self.params, self.step_fn
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    def sample(self) -> List[Dict]:
        """``check_requests`` finished requests drawn from the seed, the
        longest first."""
        done = self.done
        if not done:
            return []
        longest = max(range(len(done)), key=lambda j: done[j]["S"])
        rest = [j for j in range(len(done)) if j != longest]
        pick = torch.randperm(len(rest), generator=torch.Generator()
                              .manual_seed(_mix(self.seed, 2))).tolist()
        n = self.t["check_requests"] - 1
        return [done[longest]] + [done[rest[j]] for j in pick[:n]]

    def _ref_params(self):
        dtype = torch.bfloat16 if self.run["dtype"] == "bfloat16" \
            else torch.float32
        return weights.nest({n: t.float() for n, t in weights.make_flat(
            self.run, self.seed, self.dev, dtype).items()})

    def served_gaps(self, reqs: List[Dict]) -> List[float]:
        """How far the reference's best logit lies above that of the token
        served, for each of ``reqs``."""
        ref.no_tf32()
        p = self._ref_params()
        gaps = []
        for r in reqs:
            lg = ref.last_logits(p, self._tokens(r["i"], r["S"]), self.run)[0]
            gaps.append(float(lg.max() - lg[r["served"]]))
        return gaps

    def control(self) -> List[Dict]:
        """The control in the program's place: the sampled requests, each
        serving the token that the reference computed with float8 products
        puts first at the prompt's last position."""
        ref.no_tf32()
        p = self._ref_params()
        return [dict(r, served=int(ref.last_logits(
            p, self._tokens(r["i"], r["S"]), self.run, FP8)[0].argmax()))
            for r in self.sample()]

    def check(self, got=None) -> List[Tuple[str, float, float]]:
        """The numbers compared and their limits, of the program's served
        tokens or of ``got`` (:meth:`control`'s) in their place."""
        reqs = got if got is not None else self.sample()
        gaps = self.served_gaps(reqs)
        self.detail = {"S": [r["S"] for r in reqs], "gaps": gaps}
        nums = {"weights_mismatch": float(self.mismatch),
                "served_gap": max(gaps, default=math.inf)}
        limits = self.cell.data["limits"]
        return [(n, nums[n], limits[n]) for n in limits]


def p95(values: List[float]) -> float:
    """The 95th percentile (Python's ``statistics.quantiles``, exclusive)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20)[-1]
