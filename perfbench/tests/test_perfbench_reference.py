"""The plain reference against the port at a size the CPU holds (float32,
the port's plain kernels' versions), and its recurrences against a
step-by-step loop."""
import math

import pytest
import torch

from perfbench.lib import cell as cell_mod
from perfbench.lib import weights
from perfbench.reference import adamw as ref_adamw
from perfbench.reference import model as ref
from perfbench.tests import tiny

NAMES = sorted(tiny.RUNS)


def _config(name):
    return {"name": name, "registry": name, "run": tiny.RUNS[name]}


def _tokens(run, B, S, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, run["vocab"], (B, S + 1), generator=g)


@pytest.mark.parametrize("name", NAMES)
def test_logits_agree_with_the_port(name):
    from repro_torch.models import lm
    run = tiny.RUNS[name]
    cfg = cell_mod.port_config(_config(name))
    params = weights.make(run, 7, "cpu")
    seq = _tokens(run, 2, 24)[:, :-1]
    want = lm.forward(cfg, params, seq)
    got = ref.logits(params, ref.hidden(params, seq, run))
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_agree_with_the_port(name):
    from repro_torch.models import lm
    run = tiny.RUNS[name]
    cfg = cell_mod.port_config(_config(name))
    seq = _tokens(run, 2, 16)
    p_port = weights.make_flat(run, 5, "cpu")
    p_ref = {n: t.clone().requires_grad_(True) for n, t in p_port.items()}
    for t in p_port.values():
        t.requires_grad_(True)
    want = lm.lm_loss(cfg, weights.nest(p_port), seq[:, :-1], seq[:, 1:],
                      loss_chunk=8)
    want.backward()
    got = ref.loss(weights.nest(p_ref), seq[:, :-1], seq[:, 1:], run,
                   head_block=8) / seq[:, 1:].numel()
    got.backward()
    assert math.isclose(float(got.detach()), float(want.detach()), rel_tol=1e-5)
    for n in p_port:
        g, w = p_ref[n].grad, p_port[n].grad
        assert float((g - w).norm()) <= 1e-4 * float(w.norm()) + 1e-8, n


def _sequential(x, dt, Bm, Cm, A):
    h = x.new_zeros(x.shape[0], x.shape[2], A.shape[1])
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    return torch.stack(ys, 1)


@pytest.mark.parametrize("S,chunk,d_block", [(23, 4, 3), (32, 8, 8),
                                             (5, 64, 2), (40, 8, 100)])
def test_mamba1_scan_and_its_backward_are_the_recurrences(S, chunk, d_block):
    """In float64 against autograd of the step-by-step loop: the forward
    and every gradient to rounding."""
    g = torch.Generator().manual_seed(S)
    f64 = dict(generator=g, dtype=torch.float64)
    x = torch.randn(2, S, 6, **f64).requires_grad_()
    dt = torch.rand(2, S, 6, **f64).requires_grad_()
    Bm = torch.randn(2, S, 3, **f64).requires_grad_()
    Cm = torch.randn(2, S, 3, **f64).requires_grad_()
    A = (-torch.rand(6, 3, **f64) * 4).requires_grad_()
    dy = torch.randn(2, S, 6, **f64)
    ins = (x, dt, Bm, Cm, A)
    want = _sequential(*ins)
    got = ref.mamba1_scan(*ins, chunk=chunk, d_block=d_block)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    for a, b in zip(torch.autograd.grad(got, ins, dy),
                    torch.autograd.grad(want, ins, dy)):
        assert torch.allclose(a, b, rtol=1e-10, atol=1e-12)


def test_adamw_is_the_ports():
    from repro_torch.optim import adamw
    g = torch.Generator().manual_seed(2)
    p = {"a": torch.randn(4, 3, generator=g), "b": torch.randn(5, generator=g)}
    grads = [{k: torch.randn(v.shape, generator=g) * 3 for k, v in p.items()}
             for _ in range(3)]
    mine = {k: v.clone() for k, v in p.items()}
    port = {k: v.clone() for k, v in p.items()}
    opt = ref_adamw.AdamW(mine)
    state = adamw.init(port)
    for gr in grads:
        opt.step(mine, gr)
        port, state, _ = adamw.update(adamw.AdamWConfig(),
                                      {k: v.clone() for k, v in gr.items()},
                                      state, port)
    for k in p:
        assert torch.allclose(mine[k], port[k], rtol=1e-6, atol=1e-7)
