"""The PyTorch port's Mamba1 slice against the JAX package, on the CPU.

The K2 selective scan's plain torch version and oracle against the JAX
package's Pallas kernel (interpret mode) and its oracles, the Mamba1
blocks against ``repro.models.ssm``, and the falcon-mamba-7b smoke model
(forward, prefill, cached decode, greedy serving, checkpoints) against
``repro.models.lm``.  Inputs are made with numpy from a seed and handed to
both packages; weights are JAX's own, brought over by
``params_from_numpy``.  The CUDA kernel itself is held against the plain
version on the card by ``tests/test_torch_gpu.py``.

Tolerances: the scan 1e-5 in f32 (``tests/test_kernels.py``'s own) and
2e-2 for bf16 inputs; blocks and models 1e-4 (f32, sums in another
order); decode against prefill 2e-3, as ``tests/test_archs.py`` holds the
reference to.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore as jax_restore  # noqa: E402
from repro.checkpoint import save as jax_save  # noqa: E402
from repro.configs import get_config, smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan_kernel  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.train import step as jstep  # noqa: E402

from repro_torch import serve  # noqa: E402
from repro_torch.checkpoint import pytree_io as tio  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import smoke as tsmoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    mamba1_scan_plain, ssm_scan_cuda, ssm_scan_plain)
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "falcon-mamba-7b"
B = 2


def _scan_inputs(seed, B_, S, d, N):
    """decay in (0, 1), inc and C standard-normal scaled, as
    ``tests/test_kernels.py`` draws them."""
    rng = np.random.default_rng(seed)
    decay = 1.0 / (1.0 + np.exp(-rng.standard_normal((B_, S, d, N))))
    inc = rng.standard_normal((B_, S, d, N)) * 0.1
    C = rng.standard_normal((B_, S, N))
    return [a.astype(np.float32) for a in (decay, inc, C)]


# ------------------------------------------------------------ (a) the scan --
@pytest.mark.parametrize("B_,S,d,N,chunk,dblk", [
    (1, 8, 4, 2, 4, 4),
    (2, 16, 8, 4, 8, 4),
    (1, 32, 16, 8, 8, 8),
    (2, 24, 6, 3, 8, 6),
])
def test_plain_and_oracle_match_pallas_kernel_sweep(B_, S, d, N, chunk, dblk):
    decay, inc, C = _scan_inputs(S * 7 + N, B_, S, d, N)
    jx = [jnp.asarray(a) for a in (decay, inc, C)]
    want = np.asarray(ssm_scan_kernel(*jx, chunk=chunk, d_block=dblk,
                                      interpret=True))
    oracle = np.asarray(jref.ssm_scan_ref(*jx))
    tx = [torch.from_numpy(a) for a in (decay, inc, C)]
    got = ssm_scan_plain(*tx, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (B_, S, d)
    np.testing.assert_allclose(got.numpy(), want, **SCAN_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **SCAN_TOL)
    np.testing.assert_allclose(tref.ssm_scan_ref(*tx).numpy(), oracle,
                               **SCAN_TOL)


def test_bf16_inputs_f32_state():
    decay, inc, C = _scan_inputs(2, 1, 16, 4, 2)
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in (decay, inc, C)]
    tx = [torch.from_numpy(a).to(torch.bfloat16) for a in (decay, inc, C)]
    want = np.asarray(ssm_scan_kernel(*jx, chunk=8, d_block=4,
                                      interpret=True))
    got = ssm_scan_plain(*tx, chunk=8)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **BF16_TOL)
    np.testing.assert_allclose(tref.ssm_scan_ref(*tx).numpy(),
                               np.asarray(jref.ssm_scan_ref(*jx)),
                               **BF16_TOL)


@pytest.mark.parametrize("chunk", [1, 5, 32, 1000])
def test_plain_chunk_sizes_only_the_work(chunk):
    """The state carried across chunk boundaries is exact, for any chunk,
    one that does not divide S included."""
    tx = [torch.from_numpy(a) for a in _scan_inputs(1, 2, 32, 4, 4)]
    np.testing.assert_allclose(ssm_scan_plain(*tx, chunk=chunk).numpy(),
                               tref.ssm_scan_ref(*tx).numpy(),
                               rtol=1e-6, atol=1e-6)


# -------------------------------------------- (b) the model's chunked scan --
def test_plain_matches_model_chunked_scan():
    """≡ the reference model's ``_chunked_diag_scan`` plus an einsum."""
    decay, inc, C = _scan_inputs(3, 2, 16, 4, 4)
    hs, _ = JS._chunked_diag_scan(jnp.asarray(decay), jnp.asarray(inc),
                                  jnp.zeros((2, 4, 4)), chunk=8)
    want = jnp.einsum("bsdn,bsn->bsd", hs, jnp.asarray(C))
    got = ssm_scan_plain(*(torch.from_numpy(a) for a in (decay, inc, C)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)


def test_dispatcher_runs_the_plain_version_on_cpu():
    tx = [torch.from_numpy(a) for a in _scan_inputs(5, 2, 10, 6, 3)]
    before = ssm_scan_cuda.launches
    got = ops.ssm_scan(*tx, chunk=4)
    torch.testing.assert_close(got, ssm_scan_plain(*tx), rtol=0, atol=0)
    assert ssm_scan_cuda.launches == before   # no kernel on the CPU


def test_kernel_wrapper_refuses_cpu_tensors():
    tx = [torch.from_numpy(a) for a in _scan_inputs(6, 1, 4, 4, 2)]
    before = ssm_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_cuda(*tx)
    assert ssm_scan_cuda.launches == before


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "shape", "state",
                                 "batch", "stride"])
def test_kernel_wrapper_validates_before_launch(bad, monkeypatch):
    """The wrapper's checks run on the host; inputs that the kernel does
    not take raise before anything is launched."""
    decay = torch.zeros(2, 5, 6, 4)
    inc = torch.zeros(2, 5, 6, 4)
    C = torch.zeros(2, 5, 4)
    if bad == "dtype":
        decay, inc, C = decay.half(), inc.half(), C.half()
    elif bad == "mixed_dtype":
        C = C.to(torch.bfloat16)
    elif bad == "shape":
        C = torch.zeros(2, 5, 3)
    elif bad == "state":
        decay, inc, C = (torch.zeros(1, 2, 3, 33), torch.zeros(1, 2, 3, 33),
                         torch.zeros(1, 2, 33))
    elif bad == "batch":
        decay, inc, C = (torch.zeros(65536, 1, 1, 1),
                         torch.zeros(65536, 1, 1, 1), torch.zeros(65536, 1, 1))
    else:
        inc = torch.zeros(2, 6, 5, 4).transpose(1, 2)
    # pretend the tensors are on the card so the checks after the device
    # check are reached; nothing may launch
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    before = ssm_scan_cuda.launches
    with pytest.raises((ValueError, TypeError)):
        ssm_scan_cuda(decay, inc, C)
    assert ssm_scan_cuda.launches == before


# ------------------------------------------------------ (c) the Mamba1 blocks --
D_MODEL, D_STATE, D_CONV = 32, 4, 4


@pytest.fixture(scope="module")
def block():
    jp = JS.init_mamba1(jax.random.PRNGKey(1), D_MODEL, D_STATE, D_CONV, 2,
                        jnp.float32)
    rng = np.random.default_rng(4)
    # non-trivial biases, skip weights and decay rates
    jp = dict(jp, conv_b=jnp.asarray(rng.standard_normal(2 * D_MODEL) * 0.1,
                                     jnp.float32),
              dt_bias=jnp.asarray(rng.standard_normal(2 * D_MODEL) * 0.5,
                                  jnp.float32),
              D=jnp.asarray(rng.standard_normal(2 * D_MODEL), jnp.float32))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jp, tp


def test_causal_conv1d_and_conv_decode_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 9, 6)).astype(np.float32)
    w = rng.standard_normal((6, D_CONV)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    st = rng.standard_normal((B, D_CONV - 1, 6)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        TS.causal_conv1d(t(x), t(w), t(b)).numpy(),
        np.asarray(JS.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b))), **TOL)
    got, got_st = TS.conv_decode(t(x[:, 0]), t(st), t(w), t(b))
    want, want_st = JS.conv_decode(jnp.asarray(x[:, 0]), jnp.asarray(st),
                                   jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))


@pytest.mark.parametrize("fused", [True, False])
def test_mamba1_block_matches_jax(block, fused):
    """Each of the port's two forms (the fused scan, the unfused one on
    decay and inc built in full) against the reference's of the same
    ``fused``."""
    jp, tp = block
    u = np.random.default_rng(8).standard_normal((B, 16, D_MODEL)) \
        .astype(np.float32)
    want = JS.mamba1_block(jp, jnp.asarray(u), d_state=D_STATE, chunk=8,
                           fused=fused)
    got = TS.mamba1_block(tp, torch.from_numpy(u), d_state=D_STATE, chunk=8,
                          fused=fused)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_core_matches_the_kernel_path(block):
    """The port's plain fused core equals the unfused scan the dispatcher
    runs on decay and inc built in full, for a chunk that does not divide
    S."""
    _, tp = block
    u = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, 13, D_MODEL)).astype(np.float32))
    x, z, dt, Bs, Cs = TS._m1_gates(tp, u, tp["dt_proj"].shape[0], D_STATE)
    A = -torch.exp(tp["A_log"].float())
    fused = mamba1_scan_plain(x, dt, Bs, Cs, A, chunk=5)
    decay = torch.exp(dt[..., None] * A)
    inc = (dt * x)[..., None] * Bs[..., None, :]
    np.testing.assert_allclose(fused.numpy(),
                               ops.ssm_scan(decay, inc, Cs).numpy(), **TOL)


def test_mamba1_decode_matches_jax_from_a_nonzero_state(block):
    jp, tp = block
    rng = np.random.default_rng(10)
    u = rng.standard_normal((B, 1, D_MODEL)).astype(np.float32)
    h = rng.standard_normal((B, 2 * D_MODEL, D_STATE)).astype(np.float32)
    conv = rng.standard_normal((B, D_CONV - 1, 2 * D_MODEL)) \
        .astype(np.float32)
    want, wst = JS.mamba1_decode(
        jp, jnp.asarray(u), {"h": jnp.asarray(h), "conv": jnp.asarray(conv)},
        d_state=D_STATE)
    got, gst = TS.mamba1_decode(
        tp, torch.from_numpy(u),
        {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv)},
        d_state=D_STATE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gst["h"].numpy(), np.asarray(wst["h"]), **TOL)
    np.testing.assert_allclose(gst["conv"].numpy(), np.asarray(wst["conv"]),
                               **TOL)


def test_softplus_has_no_linear_cutoff():
    x = torch.tensor([-30.0, -1.0, 0.0, 19.0, 21.0, 100.0])
    np.testing.assert_allclose(
        TS._softplus(x).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()))), rtol=1e-6)


# ------------------------------------------- (d) the falcon-mamba smoke model --
@pytest.fixture(scope="module")
def model():
    cfg = smoke(get_config(ARCH))
    tcfg = tsmoke(tget(ARCH))
    jp = jlm.init_lm(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return cfg, tcfg, jp, tp


def _tokens(cfg, S, seed=0, batch=B):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, S)).astype(np.int32)


def test_forward_matches_jax(model):
    cfg, tcfg, jp, tp = model
    tok = _tokens(cfg, 12)
    want = jlm.forward(cfg, jp, jnp.asarray(tok))
    got = tlm.forward(tcfg, tp, torch.from_numpy(tok))
    assert got.shape == (B, 12, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_step_matches_jax(model):
    cfg, tcfg, jp, tp = model
    tok = _tokens(cfg, 10, seed=2)
    want = jstep.make_prefill_step(cfg)(jp, {"tokens": jnp.asarray(tok)})
    got = tstep.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_serve_steps_and_cache_match_jax(model):
    cfg, tcfg, jp, tp = model
    tok = _tokens(cfg, 8, seed=1)
    jcache = jlm.init_cache(cfg, B, 16)
    tcache = tlm.init_cache(tcfg, B, 16, device="cpu")
    assert tcache["ssm"]["h"].dtype == torch.float32
    assert tuple(tcache["ssm"]["h"].shape) == jcache["ssm"]["h"].shape
    assert tuple(tcache["ssm"]["conv"].shape) == jcache["ssm"]["conv"].shape
    h_buf, conv_buf = tcache["ssm"]["h"], tcache["ssm"]["conv"]
    step = jax.jit(lambda p, c, t: jlm.serve_step(cfg, p, c, t))
    for i in range(8):
        jl, jcache = step(jp, jcache, jnp.asarray(tok[:, i:i + 1]))
        tl, tcache = tlm.serve_step(tcfg, tp, tcache,
                                    torch.from_numpy(tok[:, i:i + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert int(tcache["pos"]) == i + 1
    # the state was written in place and holds what the functional one does
    assert tcache["ssm"]["h"] is h_buf and tcache["ssm"]["conv"] is conv_buf
    np.testing.assert_allclose(h_buf.numpy(), np.asarray(jcache["ssm"]["h"]),
                               **TOL)
    np.testing.assert_allclose(conv_buf.numpy(),
                               np.asarray(jcache["ssm"]["conv"]), **TOL)


def test_decode_matches_prefill(model):
    cfg, tcfg, _, tp = model
    tok = torch.from_numpy(_tokens(cfg, 8, seed=3))
    ref = tlm.forward(tcfg, tp, tok)
    cache = tlm.init_cache(tcfg, B, 8, device="cpu")
    serve_fn = tstep.make_serve_step(tcfg)
    outs = []
    for i in range(8):
        logits, cache = serve_fn(tp, cache, tok[:, i:i + 1])
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               rtol=2e-3, atol=2e-3)


def _jax_greedy(cfg, params, prompts, gen_len, max_len):
    cache = jlm.init_cache(cfg, prompts.shape[0], max_len)
    step = jax.jit(lambda p, c, t: jlm.serve_step(cfg, p, c, t))
    for i in range(prompts.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(prompts[:, i:i + 1]))
    out = []
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    for _ in range(gen_len):
        out.append(np.asarray(tok))
        logits, cache = step(params, cache, tok)
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    return np.concatenate(out, 1)


def test_generate_tokens_equal_a_jax_loop(model):
    cfg, tcfg, jp, tp = model
    prompts = _tokens(cfg, 6, seed=4, batch=3)
    with torch.inference_mode():
        out = serve.generate(tcfg, tp, torch.from_numpy(prompts), 10,
                             max_len=16)
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  _jax_greedy(cfg, jp, prompts, 10, 16))
    assert int(out["cache"]["pos"]) == 16


def _shapes(tree):
    return {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_init_lm_is_shaped_like_the_reference():
    ref = jax.eval_shape(lambda: jlm.init_lm(smoke(get_config(ARCH)),
                                             jax.random.PRNGKey(0)))
    a = tlm.init_lm(tsmoke(tget(ARCH)), 3, device="cpu")
    assert _shapes(a) == _shapes(ref)
    b = tlm.init_lm(tsmoke(tget(ARCH)), 3, device="cpu")
    assert torch.equal(a["layers"]["ssm"]["in_x"], b["layers"]["ssm"]["in_x"])


def test_init_dtype_equals_cast_params():
    """Casting each leaf as it is drawn gives the same bf16 weights as
    casting the f32 model."""
    cfg = tsmoke(tget(ARCH))
    f32 = tlm.init_lm(cfg, 1, device="cpu")
    bf = tlm.init_lm(cfg, 1, device="cpu", dtype=torch.bfloat16)
    want = dict(tio.flatten_named(tlm.cast_params(f32, torch.bfloat16))[0])
    got = dict(tio.flatten_named(bf)[0])
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        assert got[name].dtype == torch.bfloat16, name
        assert torch.equal(got[name].view(torch.int16), t.view(torch.int16)), \
            name


# ------------------------------------------------------- (e) checkpoints --
def _bits(tree):
    return {n: (tuple(t.shape), np.ascontiguousarray(np.asarray(
        t.contiguous().reshape(-1).view(torch.uint8).numpy()
        if isinstance(t, torch.Tensor) else t)).tobytes())
        for n, t in tio.flatten_named(tree)[0]}


@pytest.mark.parametrize("compressed", [False, True])
def test_jax_checkpoint_restores_bit_exactly_and_serves(tmp_path, model,
                                                        compressed):
    cfg, tcfg, jp, tp = model
    path = str(tmp_path / "w.scda")
    jax_save(path, jp, step=1000, compressed=compressed)
    like = tlm.init_lm(tcfg, 0, device="cpu")   # structure only
    weights, step = serve.load_weights(tcfg, path, like, device="cpu")
    assert step == 1000
    assert _bits(weights) == _bits(tp)
    tok = _tokens(cfg, 6, seed=5)
    np.testing.assert_allclose(
        tlm.forward(tcfg, weights, torch.from_numpy(tok)).numpy(),
        np.asarray(jlm.forward(cfg, jp, jnp.asarray(tok))), **TOL)


def test_port_save_is_byte_identical_and_restores_in_jax(tmp_path, model):
    cfg, _, jp, tp = model
    ref = str(tmp_path / "ref.scda")
    port = str(tmp_path / "port.scda")
    jax_save(ref, jp, step=4)
    tio.save(port, tp, step=4, vendor=tio.REFERENCE_VENDOR)
    with open(ref, "rb") as a, open(port, "rb") as b:
        assert a.read() == b.read()
    like = jax.eval_shape(lambda: jlm.init_lm(cfg, jax.random.PRNGKey(0)))
    got, step = jax_restore(port, like=like)
    assert step == 4
    for (n, g), (_, w) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                              jax.tree_util.tree_flatten_with_path(jp)[0]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(n))
