"""Training traffic: the port's training step on its own state, steps back
to back, each on fresh rows of uniform tokens drawn from the seed.

Set-up builds one step (``train.step.make_train_step`` with AdamW's
defaults) and one state of ``train.loop.init_state``'s structure, with
weights the harness makes from the seed; it drives the first
``warm_steps`` steps through the same call and feed as the window, and
keeps of them what the check compares: each step's loss, each leaf's
first gradient as the optimizer took it (from the moments after step 1)
and each leaf's change after ``check_steps`` steps.  The window runs steps
until ``--seconds`` have passed; the loss is read on the host after each
step, as ``train.loop.train`` does.  After the window the state is freed
and the plain reference follows the first ``check_steps`` steps from the
same weights and rows.
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List, Tuple

import torch

from perfbench.lib import cell as cell_mod
from perfbench.lib import runtime, trace, weights
from perfbench.reference import adamw as ref_adamw
from perfbench.reference import model as ref
from perfbench.reference.quant import F32, FP8

#: Leaves whose reference gradient is under this share of the median
#: leaf's move under AdamW by round-off alone: left out of the change.
STILL_LEAF = 1e-3


def _mix(seed: int, k: int) -> int:
    return (seed * 0x9E3779B1 + k * 0x85EBCA77 + 1) % (1 << 63)


class Job:
    kind = "train"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        self.run = cell.run
        self.t = cell.traffic
        self.B = cell.data["batch"]
        self.S = self.t["seq_len"]
        #: whether the check compares the first gradient itself, which then
        #: is kept on the host from step 1
        self.keep_first = "first_grad_dist" in cell.data["limits"]

    # -- the program --------------------------------------------------------
    def _batch(self, gen) -> Dict[str, torch.Tensor]:
        seq = torch.randint(0, self.run["vocab"], (self.B, self.S + 1),
                            generator=gen, device=self.dev,
                            dtype=torch.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:].long()}

    def build_step(self, **kw):
        """The port's training step with AdamW's defaults."""
        from repro_torch.optim import adamw
        from repro_torch.train.step import make_train_step
        return make_train_step(self.cfg, adamw.AdamWConfig(),
                               loss_chunk=self.t["loss_chunk"], **kw)

    def setup(self) -> Dict[str, float]:
        from repro_torch.optim import adamw
        self.cfg = cell_mod.port_config(self.cell.config)
        self.step_fn = self.build_step()
        params = weights.make(self.run, self.seed, self.dev)
        self.state = {"params": params, "opt": adamw.init(params)}
        self.gen = torch.Generator(device=self.dev).manual_seed(
            _mix(self.seed, 0))
        self.losses: List[float] = []
        b1 = adamw.AdamWConfig().b1
        for k in range(self.t["warm_steps"]):
            loss = self._step(self._batch(self.gen))
            if k < self.t["check_steps"]:
                self.losses.append(loss)
            if k == 0:
                mu = weights.flatten(self.state["opt"].mu)
                self.first = {n: float(m.norm()) / (1 - b1)
                              for n, m in mu.items()}
                if self.keep_first:
                    self.first_vec = {n: (m / (1 - b1)).cpu()
                                      for n, m in mu.items()}
            if k == self.t["check_steps"] - 1:
                self.change = self._change()
        runtime.sync(self.dev)
        return {}

    def _step(self, batch) -> float:
        params, opt, metrics = self.step_fn(self.state["params"],
                                            self.state["opt"], batch)
        self.state = {"params": params, "opt": opt}
        return float(metrics["loss"])

    def _change(self) -> Dict[str, float]:
        """Each leaf's ‖p − p0‖, p0 made again from the seed."""
        p0 = weights.make_flat(self.run, self.seed, self.dev)
        out = {n: float((p.detach() - p0[n]).norm()) for n, p in
               weights.flatten(self.state["params"]).items()}
        del p0
        return out

    def window(self, seconds: float) -> Tuple[Dict[str, float], int, int]:
        runtime.sync(self.dev)
        t0 = time.perf_counter()
        steps = failed = 0
        while True:
            loss = self._step(self._batch(self.gen))
            steps += 1
            failed += not math.isfinite(loss)
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        rate = steps * self.B * self.S / elapsed
        return {"train_tokens_per_s": rate}, steps, failed

    def traced_window(self, seconds: float):
        def work():
            t0 = time.perf_counter()
            done = []
            for _ in range(self.t["trace_steps"]):
                self._step(self._batch(self.gen))
                done.append({"B": self.B, "S": self.S})
                if time.perf_counter() - t0 >= seconds:
                    break
            return done
        return trace.traced(work, lambda: runtime.sync(self.dev))

    def release(self) -> None:
        del self.state, self.step_fn
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    def reference(self, prec=F32, against=None, keep=False):
        """The reference's losses, first gradients' norms and changes over
        the first ``check_steps`` steps, computed in ``prec`` (FP8: the
        control), and each leaf's ‖g − ``against``‖ (the first gradient
        as AdamW takes it, clipped) where ``against`` is given; with
        ``keep`` that gradient too, on the host."""
        ref.no_tf32()
        p = weights.make_flat(self.run, self.seed, self.dev)
        p0 = {n: t.clone() for n, t in p.items()}
        for t in p.values():
            t.requires_grad_(True)
        tree = weights.nest(p)
        opt = ref_adamw.AdamW(p)
        gen = torch.Generator(device=self.dev).manual_seed(_mix(self.seed, 0))
        rows = self.cell.data.get("check_rows", 1)
        losses, first, dist, kept = [], None, None, None
        for k in range(self.t["check_steps"]):
            batch = self._batch(gen)
            total = 0.0
            for r0 in range(0, self.B, rows):
                part = slice(r0, r0 + rows)
                loss = ref.loss(tree, batch["tokens"][part],
                                batch["labels"][part], self.run, prec) \
                    / (self.B * self.S)
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            grads = {n: t.grad for n, t in p.items()}
            stats = opt.step(p, grads)
            if k == 0:
                first = stats["leaf_norms"]
                g1 = {n: g * stats["scale"] for n, g in grads.items()}
                if against is not None:
                    dist = {n: float((g - against[n].to(g.device)).norm())
                            for n, g in g1.items()}
                if keep:
                    kept = {n: g.cpu() for n, g in g1.items()}
                del g1
            for t in p.values():
                t.grad = None
        change = {n: float((t.detach() - p0[n]).norm()) for n, t in p.items()}
        return losses, first, change, dist, kept

    def control(self):
        """The control's readings in the program's place: the reference's
        first steps computed with float8 products."""
        *got, _, vec = self.reference(FP8, keep=self.keep_first)
        return got, vec

    def check(self, got=None) -> List[Tuple[str, float, float]]:
        """The numbers compared and their limits, of the program's readings
        or of ``got`` (:meth:`control`'s) in their place."""
        got, vec = got or ((self.losses, self.first, self.change),
                           getattr(self, "first_vec", None))
        want = self.reference(against=vec)
        nums = compare(got, want)
        self.detail = {"loss": [got[0], want[0]],
                       "first": {n: [got[1][n], want[1][n]] for n in want[1]},
                       "change": {n: [got[2][n], want[2][n]]
                                  for n in want[2]},
                       "dist": want[3]}
        limits = self.cell.data["limits"]
        return [(n, nums[n], limits[n]) for n in limits]


def compare(got, want) -> Dict[str, float]:
    """The numbers the check compares, each a relative gap: the steps'
    losses (the worst step), the first gradient's norm and the change's
    norm by the worst leaf, against the reference's norm of that leaf or of
    the median leaf, whichever is larger.  Leaves whose reference gradient
    is under STILL_LEAF of the median leaf's are left out of the change.
    Where the reference was given the program's first gradient, also
    ``first_grad_dist``: the worst leaf's ‖g − g_ref‖ on the same scale (a
    norm averages rounding out; a distance does not)."""
    g_loss, g_first, g_change = got[:3]
    w_loss, w_first, w_change, w_dist = want[:4]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(g_loss, w_loss))
    med_first = statistics.median(w_first.values())
    first_gap = max(abs(g_first[n] - w) / max(w, med_first)
                    for n, w in w_first.items())
    moving = [n for n, w in w_first.items() if w >= STILL_LEAF * med_first]
    med_change = statistics.median(w_change[n] for n in moving)
    change_gap = max(abs(g_change[n] - w_change[n])
                     / max(w_change[n], med_change) for n in moving)
    out = {"loss_gap": loss_gap, "first_grad_gap": first_gap,
           "change_gap": change_gap}
    if w_dist is not None:
        out["first_grad_dist"] = max(d / max(w_first[n], med_first)
                                     for n, d in w_dist.items())
    return out

