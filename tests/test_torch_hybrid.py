"""The PyTorch port's Mamba2 block and hybrid family against the JAX
package, on the CPU.

The Mamba2 (SSD) block and its decode step against ``repro.models.ssm``,
the zamba2-2.7b smoke model (Mamba2 layers in groups, each group closed
by one application of the shared attention block: forward, prefill,
cached decode, greedy serving, checkpoints, the loss and its gradients)
and an ssm model built of Mamba2 blocks against ``repro.models.lm``.
Inputs are made with numpy from a seed and handed to both packages;
weights are JAX's own, brought over by ``params_from_numpy``.

Tolerances: blocks and models 1e-4 (f32, sums in another order); decode
against prefill 2e-3, as ``tests/test_archs.py`` holds the reference to;
gradients 2e-4 relative L2 against the reference's and 1e-4 against the
port's own f64 evaluation (``GRAD_REL`` says why).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore as jax_restore  # noqa: E402
from repro.checkpoint import save as jax_save  # noqa: E402
from repro.configs import get_config, smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.train import step as jstep  # noqa: E402

from repro_torch import serve  # noqa: E402
from repro_torch.checkpoint import pytree_io as tio  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import smoke as tsmoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
ARCH = "zamba2-2.7b"
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke model's ops are tiny: one thread is several times faster
    than a pool shared with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tp(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _configs(arch):
    """The reference's and the port's smoke config of ``arch``; the suffix
    ``:mamba2`` builds the model of Mamba2 blocks instead."""
    name, _, ssm_type = arch.partition(":")
    cfg, tcfg = smoke(get_config(name)), tsmoke(tget(name))
    if ssm_type:
        cfg = dataclasses.replace(cfg, ssm_type=ssm_type)
        tcfg = dataclasses.replace(tcfg, ssm_type=ssm_type)
    return cfg, tcfg


def _tokens(vocab, S, seed=0, batch=B):
    return np.random.default_rng(seed).integers(
        0, vocab, (batch, S)).astype(np.int32)


# ------------------------------------------------------ (a) the Mamba2 block --
D_MODEL, D_STATE, D_CONV, HEAD_DIM = 32, 8, 4, 16
DI = 2 * D_MODEL
HEADS = DI // HEAD_DIM


@pytest.fixture(scope="module")
def block():
    """Reference weights with non-trivial biases, decay rates, skip weights
    and norm (the reference initialises them to constants)."""
    jp = JS.init_mamba2(jax.random.PRNGKey(1), D_MODEL, D_STATE, D_CONV, 2,
                        HEAD_DIM, jnp.float32)
    rng = np.random.default_rng(4)

    def r(n, s):
        return jnp.asarray(rng.standard_normal(n) * s, jnp.float32)

    jp = dict(jp, conv_b=r(DI, 0.1), A_log=r(HEADS, 0.5),
              dt_bias=r(HEADS, 0.5), D=r(HEADS, 1.0), norm=r(DI, 0.1))
    return jp, _tp(jp)


@pytest.mark.parametrize("div", [1, 2, 4])
def test_mamba2_block_matches_jax_at_each_chunk(block, div):
    """Chunk S, S/2 and S/4: one chunk, and the inter-chunk recurrence over
    2 and 4."""
    jp, tp = block
    S = 16
    u = np.random.default_rng(8).standard_normal((B, S, D_MODEL)) \
        .astype(np.float32)
    kw = dict(d_state=D_STATE, head_dim=HEAD_DIM, chunk=S // div)
    want = JS.mamba2_block(jp, jnp.asarray(u), **kw)
    got = TS.mamba2_block(tp, torch.from_numpy(u), **kw)
    assert got.shape == (B, S, D_MODEL) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mamba2_block_needs_whole_chunks(block):
    _, tp = block
    with pytest.raises(AssertionError, match="chunk"):
        TS.mamba2_block(tp, torch.zeros(B, 12, D_MODEL), d_state=D_STATE,
                        head_dim=HEAD_DIM, chunk=8)


def test_mamba2_decode_matches_jax_from_a_nonzero_state(block):
    jp, tp = block
    rng = np.random.default_rng(10)
    u = rng.standard_normal((B, 1, D_MODEL)).astype(np.float32)
    h = rng.standard_normal((B, HEADS, D_STATE, HEAD_DIM)).astype(np.float32)
    conv = rng.standard_normal((B, D_CONV - 1, DI)).astype(np.float32)
    kw = dict(d_state=D_STATE, head_dim=HEAD_DIM)
    want, wst = JS.mamba2_decode(
        jp, jnp.asarray(u), {"h": jnp.asarray(h), "conv": jnp.asarray(conv)},
        **kw)
    got, gst = TS.mamba2_decode(
        tp, torch.from_numpy(u),
        {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv)}, **kw)
    assert gst["h"].dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gst["h"].numpy(), np.asarray(wst["h"]), **TOL)
    np.testing.assert_array_equal(gst["conv"].numpy(),
                                  np.asarray(wst["conv"]))


def test_mamba2_decode_steps_equal_the_block(block):
    """Decoding a sequence token by token from the zero state gives the
    chunked block's outputs."""
    _, tp = block
    cfg = dataclasses.replace(tsmoke(tget(ARCH)), d_model=D_MODEL,
                              ssm_state=D_STATE, ssm_head_dim=HEAD_DIM)
    u = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (B, 12, D_MODEL)).astype(np.float32))
    want = TS.ssm_block(tp, u, cfg, chunk=4)
    state = TS.init_ssm_state(cfg, B)
    assert tuple(state["h"].shape) == (B, HEADS, D_STATE, HEAD_DIM)
    outs = []
    for t in range(12):
        o, state = TS.ssm_decode(tp, u[:, t:t + 1], state, cfg)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), want.numpy(),
                               **DECODE_TOL)


# --------------------------------------------- (b) the zamba2 smoke model --
@pytest.fixture(scope="module")
def model():
    cfg, tcfg = _configs(ARCH)
    jp = jlm.init_lm(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, jp, _tp(jp)


def test_smoke_config_is_a_hybrid_of_groups(model):
    cfg, tcfg, _, tp = model
    assert tcfg.family == "hybrid" and tcfg.ssm_type == "mamba2"
    assert tcfg.n_layers // tcfg.shared_attn_every == 2
    assert sorted(tp["shared_attn"]) == ["attn", "ln"]


def test_forward_matches_jax(model):
    cfg, tcfg, jp, tp = model
    tok = _tokens(cfg.vocab, 12)
    want = jlm.forward(cfg, jp, jnp.asarray(tok))
    got = tlm.forward(tcfg, tp, torch.from_numpy(tok))
    assert got.shape == (B, 12, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_step_matches_jax(model):
    cfg, tcfg, jp, tp = model
    tok = _tokens(cfg.vocab, 10, seed=2)
    want = jstep.make_prefill_step(cfg)(jp, {"tokens": jnp.asarray(tok)})
    got = tstep.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_shared_attention_runs_once_a_group(model, monkeypatch):
    """The forward applies the shared attention once a group, and so does
    each decode step, every application through ops.flash_attention."""
    _, tcfg, _, tp = model
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    G = tcfg.n_layers // tcfg.shared_attn_every
    tlm.forward(tcfg, tp, torch.from_numpy(_tokens(tcfg.vocab, 6)))
    assert calls == [(6, 6)] * G
    calls.clear()
    cache = tlm.init_cache(tcfg, B, 8, device="cpu")
    tlm.serve_step(tcfg, tp, cache, torch.zeros(B, 1, dtype=torch.int32))
    assert calls == [(1, 8)] * G


def test_init_cache_is_shaped_like_the_reference(model):
    cfg, tcfg, _, _ = model
    want = jlm.init_cache(cfg, B, 16)
    got = tlm.init_cache(tcfg, B, 16, device="cpu")
    assert _shapes(got) == _shapes(want)
    for name, t in tio.flatten_named(got)[0]:
        assert torch.count_nonzero(t) == 0, name
    assert got["ssm"]["h"].dtype == torch.float32
    assert got["k"].shape[0] == cfg.n_layers // cfg.shared_attn_every


def test_serve_steps_and_caches_match_jax(model):
    cfg, tcfg, jp, tp = model
    tok = _tokens(cfg.vocab, 8, seed=1)
    jcache = jlm.init_cache(cfg, B, 16)
    tcache = tlm.init_cache(tcfg, B, 16, device="cpu")
    bufs = {n: t for n, t in tio.flatten_named(tcache)[0] if n != "pos"}
    step = jax.jit(lambda p, c, t: jlm.serve_step(cfg, p, c, t))
    for i in range(8):
        jl, jcache = step(jp, jcache, jnp.asarray(tok[:, i:i + 1]))
        tl, tcache = tlm.serve_step(tcfg, tp, tcache,
                                    torch.from_numpy(tok[:, i:i + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert int(tcache["pos"]) == i + 1
    # the state and the KV caches were written in place and hold what the
    # functional ones do
    want = dict(tio.flatten_named(_tp(jcache))[0])
    for name, t in tio.flatten_named(tcache)[0]:
        if name != "pos":
            assert t is bufs[name], name
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


def test_decode_matches_prefill(model):
    cfg, tcfg, _, tp = model
    tok = torch.from_numpy(_tokens(cfg.vocab, 8, seed=3))
    ref = tlm.forward(tcfg, tp, tok)
    cache = tlm.init_cache(tcfg, B, 8, device="cpu")
    serve_fn = tstep.make_serve_step(tcfg)
    outs = []
    for i in range(8):
        logits, cache = serve_fn(tp, cache, tok[:, i:i + 1])
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               **DECODE_TOL)


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
    prompts = _tokens(cfg.vocab, 6, seed=4, batch=3)
    with torch.inference_mode():
        out = serve.generate(tcfg, tp, torch.from_numpy(prompts), 10,
                             max_len=16)
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  _jax_greedy(cfg, jp, prompts, 10, 16))
    assert int(out["cache"]["pos"]) == 16


def test_serve_example_runs_on_the_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--gen-len", "4", "--prompt-len", "3", "--max-len",
                      "8"])
    assert tuple(out["tokens"].shape) == (4, 4)
    assert "served 4 requests" in capsys.readouterr().out


# ---------------------------------------------- (c) loss and gradients --
#: Gradients against the reference's, relative L2: two f32 evaluations of
#: 4 layers in another order.  A_log's gradient, a sum over every position
#: with cancellation, is the farthest apart (1.2e-4 on this input); against
#: an f64 evaluation the port's f32 gradients are within GRAD_F64 (A_log at
#: 9e-5) and the reference's within 3e-5.
GRAD_REL = 2e-4
GRAD_F64 = 1e-4


def _loss_and_grads(tcfg, params, tok, lab, remat, chunk):
    named = tio.flatten_named(params)[0]
    leaves = [p.requires_grad_() for _, p in named]
    loss = tlm.lm_loss(tcfg, params, torch.from_numpy(tok),
                       torch.from_numpy(lab), loss_chunk=chunk, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), {n: g for (n, _), g in zip(named, grads)}


def _rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_gradients_match_jax(model, remat, monkeypatch):
    """lm_loss and every parameter's gradient against jax.value_and_grad
    (whose forward remats each group); ``remat`` runs the port's groups
    under torch.utils.checkpoint or not.  The port's gradients are also
    held against its own evaluation in f64."""
    cfg, tcfg, jp, _ = model
    S, chunk = 32, 16
    seq = _tokens(cfg.vocab, S + 1, seed=6)
    tok, lab = seq[:, :-1], seq[:, 1:]
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm.lm_loss(cfg, p, jnp.asarray(tok), jnp.asarray(lab),
                              loss_chunk=chunk))(jp)
    loss, grads = _loss_and_grads(tcfg, _tp(jp), tok, lab, remat, chunk)
    assert abs(loss - float(jloss)) <= 1e-5
    want = dict(tio.flatten_named(_tp(jgrads))[0])
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        assert _rel(g, want[name]) <= GRAD_REL, name

    monkeypatch.setattr(tlm, "compute_dtype", lambda cfg: torch.float64)
    p64 = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu",
                            torch.float64)
    loss64, grads64 = _loss_and_grads(tcfg, p64, tok, lab, remat, chunk)
    assert abs(loss - loss64) <= 1e-5
    for name, g in grads.items():
        assert _rel(g, grads64[name]) <= GRAD_F64, name


def test_per_layer_cast_equals_the_cast_once_serve_path(model):
    """bf16 compute: forward_hidden on f32 master weights with remat (each
    group's weights cast inside its checkpointed body) gives the bits of
    the serving forward on weights cast once."""
    _, tcfg, _, tp = model
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    tok = torch.from_numpy(_tokens(cfg.vocab, 16, seed=7))
    with torch.no_grad():
        got, _ = tlm.forward_hidden(cfg, tp, tok, remat=True)
        want, _ = tlm.forward_hidden(
            cfg, tlm.cast_params(tp, torch.bfloat16), tok)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


# ------------------------------------ (d) an ssm model of Mamba2 blocks --
def test_mamba2_ssm_model_matches_jax():
    cfg, tcfg = _configs("falcon-mamba-7b:mamba2")
    jp = jlm.init_lm(cfg, jax.random.PRNGKey(2))
    tp = _tp(jp)
    tok = _tokens(cfg.vocab, 12, seed=8)
    np.testing.assert_allclose(
        tlm.forward(tcfg, tp, torch.from_numpy(tok)).numpy(),
        np.asarray(jlm.forward(cfg, jp, jnp.asarray(tok))), **TOL)
    jcache = jlm.init_cache(cfg, B, 4)
    tcache = tlm.init_cache(tcfg, B, 4, device="cpu")
    assert _shapes(tcache) == _shapes(jcache)
    for i in range(4):
        jl, jcache = jlm.serve_step(cfg, jp, jcache,
                                    jnp.asarray(tok[:, i:i + 1]))
        tl, tcache = tlm.serve_step(tcfg, tp, tcache,
                                    torch.from_numpy(tok[:, i:i + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


# --------------------------------------------------- (e) init and shapes --
def _shapes(tree):
    return {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", [ARCH, "falcon-mamba-7b:mamba2"])
def test_init_lm_is_shaped_like_the_reference(arch):
    cfg, tcfg = _configs(arch)
    ref = jax.eval_shape(lambda: jlm.init_lm(cfg, jax.random.PRNGKey(0)))
    a = tlm.init_lm(tcfg, 3, device="cpu")
    assert _shapes(a) == _shapes(ref)
    assert _shapes(tlm.init_lm(tcfg, 3, device="meta")) == _shapes(ref)
    b = tlm.init_lm(tcfg, 3, device="cpu")
    assert torch.equal(a["layers"]["ssm"]["in_x"], b["layers"]["ssm"]["in_x"])


def test_init_lm_refuses_layers_that_do_not_fill_groups():
    cfg = dataclasses.replace(tsmoke(tget(ARCH)), n_layers=5)
    with pytest.raises(ValueError, match="shared_attn_every"):
        tlm.init_lm(cfg, 0, device="cpu")


def test_init_dtype_equals_cast_params():
    """Casting each leaf as it is drawn gives the same bf16 weights as
    casting the f32 model, the shared attention included."""
    cfg = tsmoke(tget(ARCH))
    f32 = tlm.init_lm(cfg, 1, device="cpu")
    bf = tlm.init_lm(cfg, 1, device="cpu", dtype=torch.bfloat16)
    want = dict(tio.flatten_named(tlm.cast_params(f32, torch.bfloat16))[0])
    got = dict(tio.flatten_named(bf)[0])
    assert sorted(got) == sorted(want)
    assert any(n.startswith("shared_attn/") for n in got)
    for name, t in want.items():
        assert got[name].dtype == torch.bfloat16, name
        assert torch.equal(got[name].view(torch.int16), t.view(torch.int16)), \
            name


# ------------------------------------------------------- (f) checkpoints --
def _bits(tree):
    return {n: (tuple(t.shape), np.ascontiguousarray(
        t.contiguous().reshape(-1).view(torch.uint8).numpy()).tobytes())
        for n, t in tio.flatten_named(tree)[0]}


def test_params_from_numpy_carries_the_hybrid_tree(model):
    cfg, _, jp, tp = model
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert sorted(got) == sorted(want)
    assert any("shared_attn" in k for k in got)
    for k, w in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


@pytest.mark.parametrize("compressed", [False, True])
def test_jax_checkpoint_restores_bit_exactly_and_serves(tmp_path, model,
                                                        compressed):
    cfg, tcfg, jp, tp = model
    path = str(tmp_path / "w.scda")
    jax_save(path, jp, step=1000, compressed=compressed)
    like = tlm.init_lm(tcfg, 0, device="meta")   # structure only
    weights, step = serve.load_weights(tcfg, path, like, device="cpu")
    assert step == 1000
    assert _bits(weights) == _bits(tp)
    tok = _tokens(cfg.vocab, 6, seed=5)
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
