"""The port's Mamba1 training slice against the JAX package, on the CPU:
the fused scan's plain version and its gradient against ``jax.vjp`` of the
reference's fused core, the Mamba1 block's two forms and their gradients,
the backward's checkpointed reverse walk (the kernel's plain version)
against autograd, and the fused kernels' wrappers and dispatcher on the
CPU.  The falcon-mamba smoke model's loss, gradients, train step and loop
are the dense tests of ``test_torch_train.py`` and ``test_torch_loop.py``,
run for both archs.  The CUDA kernels themselves are held against these
plain versions on the card by ``tests/test_torch_gpu.py``.

Tolerances, all f32: 1e-5 for the scan and its gradients (sums in another
order), 1e-4 for the blocks (as ``test_torch_ssm.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as JS  # noqa: E402

from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _core_inputs(seed, B, S, d, N):
    """x, dt, B, C, A and dy as the model makes them: dt a softplus, A the
    negated exponential of log(1..N) scaled per channel."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, d))))
    Bs = rng.standard_normal((B, S, N))
    Cs = rng.standard_normal((B, S, N))
    A = -np.exp(np.log(np.arange(1, N + 1))[None, :]
                + 0.3 * rng.standard_normal((d, N)))
    dy = rng.standard_normal((B, S, d))
    return [a.astype(np.float32) for a in (x, dt, Bs, Cs, A, dy)]


# ------------------------------------------- the fused core against JAX --
@pytest.mark.parametrize("B,S,d,N,chunk", [
    (1, 8, 4, 1, 8),
    (2, 16, 6, 3, 8),
    (2, 24, 5, 8, 4),
    (1, 32, 3, 16, 32),
])
def test_fused_scan_and_its_gradient_match_jax(B, S, d, N, chunk):
    """``mamba1_scan_plain`` and autograd of it against the reference's
    ``_mamba1_core_fused`` and ``jax.vjp`` of it, for every input."""
    x, dt, Bs, Cs, A, dy = _core_inputs(S + N, B, S, d, N)
    h0 = jnp.zeros((B, d, N), jnp.float32)
    want, vjp = jax.vjp(
        lambda *a: JS._mamba1_core_fused(*a, h0, chunk),
        *(jnp.asarray(a) for a in (x, dt, Bs, Cs, A)))
    want_grads = vjp(jnp.asarray(dy))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, dt, Bs, Cs, A)]
    got = ss.mamba1_scan_plain(*leaves, chunk=chunk)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **SCAN_TOL)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(dy))
    for name, g, w in zip(("x", "dt", "B", "C", "A"), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SCAN_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_fused_scan_chunk_sizes_only_the_work(chunk):
    x, dt, Bs, Cs, A, _ = (torch.from_numpy(a)
                           for a in _core_inputs(2, 2, 20, 4, 3))
    torch.testing.assert_close(ss.mamba1_scan_plain(x, dt, Bs, Cs, A,
                                                    chunk=chunk),
                               ss.mamba1_scan_plain(x, dt, Bs, Cs, A,
                                                    chunk=20),
                               rtol=1e-6, atol=1e-6)


# --------------------------------------------- the blocks against JAX --
D_MODEL, D_STATE, D_CONV = 32, 4, 4


@pytest.fixture(scope="module")
def block():
    jp = JS.init_mamba1(jax.random.PRNGKey(2), D_MODEL, D_STATE, D_CONV, 2,
                        jnp.float32)
    rng = np.random.default_rng(5)
    jp = dict(jp, conv_b=jnp.asarray(rng.standard_normal(2 * D_MODEL) * 0.1,
                                     jnp.float32),
              dt_bias=jnp.asarray(rng.standard_normal(2 * D_MODEL) * 0.5,
                                  jnp.float32),
              D=jnp.asarray(rng.standard_normal(2 * D_MODEL), jnp.float32))
    return jp


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


@pytest.mark.parametrize("fused", [True, False])
def test_mamba1_block_values_and_gradients_match_jax(block, fused):
    """The block's output, dL/du and every parameter's gradient, the
    port's form against the reference's of the same ``fused``."""
    jp = block
    rng = np.random.default_rng(11)
    u = rng.standard_normal((2, 16, D_MODEL)).astype(np.float32)
    dout = rng.standard_normal((2, 16, D_MODEL)).astype(np.float32)
    want, vjp = jax.vjp(lambda p, v: JS.mamba1_block(
        p, v, d_state=D_STATE, chunk=8, fused=fused), jp, jnp.asarray(u))
    jgrads, jdu = vjp(jnp.asarray(dout))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    named = _flat(tp)
    leaves = [p.requires_grad_() for _, p in named]
    tu = torch.from_numpy(u).requires_grad_()
    got = TS.mamba1_block(tp, tu, d_state=D_STATE, chunk=8, fused=fused)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    grads = torch.autograd.grad(got, leaves + [tu], torch.from_numpy(dout))
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jdu), **TOL,
                               err_msg="du")
    want_grads = dict(_flat(jax.tree_util.tree_map(np.asarray, jgrads)))
    for (name, _), g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), want_grads[name], **TOL,
                                   err_msg=name)


# ------------------------------- the backward's walk against autograd --
@pytest.mark.parametrize("B,S,d,N,every", [
    (2, 32, 5, 1, 16),    # T divides S, one state a channel
    (2, 37, 6, 8, 16),    # T does not divide S
    (1, 16, 3, 8, 16),    # one segment
    (2, 9, 4, 8, 4),      # a short last segment
    (1, 20, 7, 1, 7),
])
def test_bwd_plain_matches_autograd(B, S, d, N, every):
    """``mamba1_scan_bwd_plain`` (states every ``every`` steps, segments
    recomputed and walked backward) against autograd of
    ``mamba1_scan_plain``, every input's gradient."""
    x, dt, Bs, Cs, A, dy = (torch.from_numpy(a)
                            for a in _core_inputs(S * 3 + N, B, S, d, N))
    leaves = [t.clone().requires_grad_() for t in (x, dt, Bs, Cs, A)]
    want = torch.autograd.grad(ss.mamba1_scan_plain(*leaves, chunk=8),
                               leaves, dy)
    got = ss.mamba1_scan_bwd_plain(x, dt, Bs, Cs, A, dy, every=every)
    for name, g, w in zip(("x", "dt", "B", "C", "A"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        torch.testing.assert_close(g, w, **SCAN_TOL, msg=f"d{name}")


def test_bwd_plain_reads_strided_b_and_c_and_bf16():
    """B and C as row slices of one wider tensor, as the model passes them;
    bf16 inputs give bf16 gradients (dA stays f32)."""
    x, dt, Bs, Cs, A, dy = (torch.from_numpy(a)
                            for a in _core_inputs(7, 2, 19, 6, 4))
    dbc = torch.cat([torch.zeros(2, 19, 3), Bs, Cs], -1)
    Bv, Cv = dbc[..., 3:7], dbc[..., 7:]
    torch.testing.assert_close(
        ss.mamba1_scan_bwd_plain(x, dt, Bv, Cv, A, dy),
        ss.mamba1_scan_bwd_plain(x, dt, Bs.clone(), Cs.clone(), A, dy),
        rtol=0, atol=0)
    bf = [t.to(torch.bfloat16) for t in (x, dt, Bs, Cs)]
    got = ss.mamba1_scan_bwd_plain(*bf, A, dy)
    assert [g.dtype for g in got] == [torch.bfloat16] * 4 + [torch.float32]


@pytest.mark.parametrize("S", [0, 1, 16, 17, 40])
def test_states_are_the_recurrence_every_t_steps(S):
    x, dt, Bs, Cs, A, _ = (torch.from_numpy(a)
                           for a in _core_inputs(S + 1, 2, S, 3, 5))
    states = ss.scan_states_plain(x, dt, Bs, A)
    assert tuple(states.shape) == ss.states_shape(2, S, 3, 5)
    decay, inc = ss.decay_inc(dt, x, Bs, A)
    h = torch.zeros(2, 3, 5)
    for t in range(S):
        if t % ss.STATE_EVERY == 0:
            torch.testing.assert_close(states[:, t // ss.STATE_EVERY], h,
                                       rtol=0, atol=0)
        h = decay[:, t] * h + inc[:, t]


def test_bwd_plan_covers_d_with_small_partials():
    for B, S, d, N in ((8, 1024, 8192, 16), (4, 512, 8192, 16), (2, 7, 5, 3),
                       (1, 3, 128, 1), (8, 4, 100_000, 32),
                       (65535, 1, 8192, 16)):
        plan = ss.bwd_plan(B, S, d, N, 2, True)
        P = 1 << max(0, N - 1).bit_length()
        assert plan.lanes == ss.BWD_LANES[P]
        assert plan.lanes * plan.lane_states == P <= 8 * plan.lanes
        assert plan.channels == ss.BWD_THREADS // plan.lanes * plan.passes
        assert plan.channels <= ss.BWD_MAX_CHANNELS
        covered = plan.grid[0] * plan.channels
        assert covered >= d > covered - plan.channels
        assert plan.partials == ((2, plan.grid[0], B, S, N), (B, d, N))
    # falcon-mamba's training shape: 4 lanes a channel, 4 passes of 32
    # channels a block, 64 blocks along d (partials of 67 MB)
    plan = ss.bwd_plan(8, 1024, 8192, 16, 2, True)
    assert (plan.lanes, plan.channels, plan.passes, plan.grid) == \
        (4, 128, 4, (64, 8))


# ----------------------------------------- wrappers and the dispatcher --
def test_dispatcher_runs_the_plain_fused_scan_on_cpu():
    x, dt, Bs, Cs, A, dy = (torch.from_numpy(a)
                            for a in _core_inputs(3, 2, 12, 4, 3))
    before = (ss.ssm_scan_fused_cuda.launches, ss.ssm_scan_bwd_cuda.launches)
    leaves = [t.clone().requires_grad_() for t in (x, dt, Bs, Cs, A)]
    got = ops.mamba1_scan(*leaves, chunk=4)
    torch.testing.assert_close(got, ss.mamba1_scan_plain(x, dt, Bs, Cs, A),
                               rtol=0, atol=0)
    assert got.grad_fn is not None
    got.backward(dy)
    assert all(t.grad is not None for t in leaves)
    assert (ss.ssm_scan_fused_cuda.launches,
            ss.ssm_scan_bwd_cuda.launches) == before   # no kernel on the CPU


def test_fused_wrappers_refuse_cpu_tensors():
    x, dt, Bs, Cs, A, dy = (torch.from_numpy(a)
                            for a in _core_inputs(4, 1, 4, 4, 2))
    states = torch.zeros(ss.states_shape(1, 4, 4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssm_scan_fused_cuda(x, dt, Bs, Cs, A)
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssm_scan_bwd_cuda(x, dt, Bs, Cs, A, dy, states)


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "A_dtype", "shape",
                                 "state", "batch", "stride", "rows",
                                 "states", "dy"])
def test_fused_wrappers_validate_before_launch(bad, monkeypatch):
    """Inputs the fused kernels do not take raise on the host, before
    anything is launched."""
    B, S, d, N = 2, 5, 6, 4
    x, dt = torch.zeros(B, S, d), torch.zeros(B, S, d)
    Bs, Cs = torch.zeros(B, S, N), torch.zeros(B, S, N)
    A, dy = torch.zeros(d, N), torch.zeros(B, S, d)
    states = torch.zeros(ss.states_shape(B, S, d, N))
    if bad == "dtype":
        x, dt, Bs, Cs = (t.half() for t in (x, dt, Bs, Cs))
    elif bad == "mixed_dtype":
        Cs = Cs.to(torch.bfloat16)
    elif bad == "A_dtype":
        A = A.to(torch.bfloat16)
    elif bad == "shape":
        Cs = torch.zeros(B, S, 3)
    elif bad == "state":
        Bs, Cs, A = torch.zeros(B, S, 33), torch.zeros(B, S, 33), \
            torch.zeros(d, 33)
    elif bad == "batch":
        x = dt = dy = torch.zeros(65536, 1, 1)
        Bs = Cs = torch.zeros(65536, 1, 1)
        A = torch.zeros(1, 1)
    elif bad == "stride":
        Bs = torch.zeros(B, N, S).transpose(1, 2)
    elif bad == "rows":
        # rows 4 apart within a batch row, batch rows 30 apart
        Bs = torch.as_strided(torch.zeros(64), (B, S, N), (30, 4, 1))
    elif bad == "states":
        states = torch.zeros(B, 2, d, N)
    else:
        dy = dy.to(torch.bfloat16)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    before = (ss.ssm_scan_fused_cuda.launches, ss.ssm_scan_bwd_cuda.launches)
    if bad not in ("states", "dy"):
        with pytest.raises((ValueError, TypeError)):
            ss.ssm_scan_fused_cuda(x, dt, Bs, Cs, A)
    with pytest.raises((ValueError, TypeError)):
        ss.ssm_scan_bwd_cuda(x, dt, Bs, Cs, A, dy, states)
    assert (ss.ssm_scan_fused_cuda.launches,
            ss.ssm_scan_bwd_cuda.launches) == before
