"""The faults a run's check has to catch, planted from outside the timed
path: each wraps the step a driver's ``Job.build_step`` makes (the tests
and ``tools/calibrate.py`` plant them; the benchmark's runs never do).

Training: ``unchanged`` (the step hands back its state as it found it),
``half_batch`` (half of the rows left out, the mean taken over the
rest), ``grad_doubled`` (one leaf's gradient doubled before AdamW takes
it).  Prefill: ``token_altered`` (the logits negated where they are
produced, so the token served is the least likely).
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from perfbench.lib import weights

FAULTS: Dict[str, tuple] = {
    "train": ("unchanged", "half_batch", "grad_doubled"),
    "prefill": ("token_altered",),
}
#: The leaf whose gradient ``grad_doubled`` doubles.
DOUBLED_LEAF = ("layers", "ssm", "out_proj")


def plant(job, fault: str) -> None:
    """Make ``job`` build a faulty step in its set-up."""
    if fault not in FAULTS[job.kind]:
        raise ValueError(f"{job.kind} has no fault {fault!r}")
    build = job.build_step
    if fault == "grad_doubled":
        job.build_step = lambda: build(grad_transform=_double_leaf)
        return
    wrap = {"unchanged": _unchanged, "half_batch": _half_batch,
            "token_altered": _negated}[fault]
    job.build_step = lambda: wrap(build())


def _unchanged(step: Callable) -> Callable:
    def faulty(params, opt, batch):
        keep = [t.clone() for t in _leaves(params, opt)]
        params, opt, metrics = step(params, opt, batch)
        with torch.no_grad():
            for t, k in zip(_leaves(params, opt), keep):
                t.copy_(k)
        return params, opt, metrics
    return faulty


def _half_batch(step: Callable) -> Callable:
    def faulty(params, opt, batch):
        return step(params, opt, {k: v[:len(v) // 2]
                                  for k, v in batch.items()})
    return faulty


def _negated(step: Callable) -> Callable:
    return lambda params, batch: -step(params, batch)


def _leaves(params, opt) -> List[torch.Tensor]:
    out = list(weights.flatten(params).values())
    out += list(weights.flatten(opt.mu).values())
    out += list(weights.flatten(opt.nu).values())
    out.append(opt.count)
    return out


def _double_leaf(grads):
    node = grads
    for k in DOUBLED_LEAF[:-1]:
        node = node[k]
    node[DOUBLED_LEAF[-1]] = node[DOUBLED_LEAF[-1]] * 2
    return grads
