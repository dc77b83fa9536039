"""The port's training path against the JAX package's, on the CPU: the
attention gradient, the loss and every parameter's gradient of the qwen3,
falcon-mamba, zamba2, gemma3 and granite-moe smoke configs, one train step (the loop is in
test_torch_loop.py; the Mamba1 scan's gradient in test_torch_ssm_train.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import step as jstep  # noqa: E402

from repro_torch.checkpoint.pytree_io import flatten_named  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import smoke as tsmoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

#: The dense, the Mamba1 (ssm), the hybrid and the moe family: every
#: model-level test runs on their smoke configs.
ARCHS = ("qwen3-1.7b", "falcon-mamba-7b", "zamba2-2.7b", "gemma3-4b",
         "granite-moe-3b-a800m")
B, S, CHUNK = 2, 32, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke model's ops are tiny: one thread is several times faster
    than a pool shared with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = smoke(get_config(request.param))
    jp = jlm.init_lm(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    seq = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return cfg, tsmoke(tget(request.param)), jp, seq[:, :-1], seq[:, 1:]


def _tp(jp):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


# ------------------------------------------------------- attention gradient --
@pytest.mark.parametrize("B_,H,Hkv,Sq,Skv,causal,window,q_offset", [
    (2, 4, 2, 16, 16, True, None, 0),      # GQA
    (1, 4, 1, 37, 37, True, 8, 0),         # window, ragged S
    (1, 2, 2, 20, 45, False, None, 0),     # non-causal, Sq != Skv
    (2, 4, 2, 5, 30, True, 7, 25),         # offset, window
])
def test_attention_gradient_matches_jax(B_, H, Hkv, Sq, Skv, causal, window,
                                        q_offset):
    """Autograd of the plain version against jax's gradient of the
    reference: the oracle the card holds K1's backward to (f32, 1e-5)."""
    rng = np.random.default_rng(Sq + Skv)
    D = 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B_, Sq, H, D), (B_, Skv, Hkv, D),
                         (B_, Skv, Hkv, D)))
    dout = rng.standard_normal((B_, Sq, H, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_chunk=16)
    _, vjp = jax.vjp(lambda a, b, c: JL.flash_attention(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention_plain(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("B_,H,Hkv,Sq,Skv,causal,window,q_offset", [
    (2, 4, 2, 16, 16, True, None, 0),      # GQA
    (1, 4, 1, 37, 37, True, 8, 0),         # window, ragged S
    (1, 2, 2, 20, 45, False, None, 0),     # non-causal, Sq != Skv
    (2, 4, 2, 5, 30, True, 7, 25),         # offset, window
    (1, 2, 1, 6, 6, True, 0, 0),           # empty window: rows with no key
])
def test_backward_formula_from_lse_and_delta(B_, H, Hkv, Sq, Skv, causal,
                                            window, q_offset):
    """The backward kernels' arithmetic in plain torch: P = exp2(s log2(e)
    - LSE) from :func:`lse_plain` (+inf for a row with no key), Δ from
    :func:`delta_plain`, dS = P (dP - Δ), dK and dV summed over each GQA
    group; equal to autograd of the plain version (f32, 1e-5)."""
    import math
    from repro_torch.kernels.flash_attention import (LOG2E, delta_plain,
                                                     flash_attention_bwd_plain,
                                                     lse_plain)
    rng = np.random.default_rng(Sq * 3 + Skv)
    D, rep = 16, H // Hkv
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B_, Sq, H, D), (B_, Skv, Hkv, D), (B_, Skv, Hkv, D)))
    dout = torch.from_numpy(rng.standard_normal((B_, Sq, H, D))
                            .astype(np.float32))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = flash_attention_plain(q, k, v, **kw)
    lse = lse_plain(q, k, v, **kw)
    lse = torch.where(torch.isfinite(lse), lse, math.inf)
    kr, vr = (t.repeat_interleave(rep, dim=2) for t in (k, v))
    s = torch.einsum("bshd,bchd->bhsc", q, kr) / math.sqrt(D)
    q_pos = q_offset + torch.arange(Sq)[:, None]
    kv_pos = torch.arange(Skv)[None, :]
    mask = (kv_pos <= q_pos) if causal else torch.ones(Sq, Skv, dtype=bool)
    if window is not None:
        mask = mask & (q_pos - kv_pos < window)
    p = torch.where(mask, torch.exp2(s * LOG2E - lse[..., None]), 0.0)
    dp = torch.einsum("bshd,bchd->bhsc", dout, vr)
    ds = p * (dp - delta_plain(out, dout)[..., None])
    dq = torch.einsum("bhsc,bchd->bshd", ds, kr) / math.sqrt(D)
    dk = torch.einsum("bhsc,bshd->bchd", ds, q) / math.sqrt(D)
    dv = torch.einsum("bhsc,bshd->bchd", p, dout)
    dk, dv = (t.reshape(B_, Skv, Hkv, rep, D).sum(3) for t in (dk, dv))
    want = flash_attention_bwd_plain(q, k, v, dout, **kw)
    for name, g, w in zip("qkv", (dq, dk, dv), want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5,
                                   msg=f"d{name}")


# ------------------------------------------------------ loss and gradients --
def test_loss_and_gradients_match_jax(model):
    cfg, tcfg, jp, tok, lab = model
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm.lm_loss(cfg, p, jnp.asarray(tok), jnp.asarray(lab),
                              loss_chunk=CHUNK))(jp)
    tp = _tp(jp)
    named = _named(tp)
    for _, p in named:
        p.requires_grad_()
    loss = tlm.lm_loss(tcfg, tp, torch.from_numpy(tok),
                       torch.from_numpy(lab), loss_chunk=CHUNK)
    assert abs(loss.item() - float(jloss)) <= 1e-5
    grads = torch.autograd.grad(loss, [p for _, p in named])
    want = dict(_named(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert len(grads) == len(want)
    for (name, _), g in zip(named, grads):
        w = want[name]
        rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert rel <= 1e-4, f"{name}: relative L2 {rel}"


def test_remat_does_not_change_the_loss_or_gradients(model):
    cfg, tcfg, jp, tok, lab = model
    out = []
    for remat in (True, False):
        tp = _tp(jp)
        leaves = [p.requires_grad_() for _, p in _named(tp)]
        loss = tlm.lm_loss(tcfg, tp, torch.from_numpy(tok),
                           torch.from_numpy(lab), loss_chunk=CHUNK,
                           remat=remat)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_train_step_matches_jax(model):
    """One make_train_step step: params, optimizer state and metrics, all
    at 1e-5.  qwen3's parameters are held element by element against the
    reference's step.  falcon-mamba's and zamba2's are held in two parts,
    because some of their smoke gradients sit near AdamW's eps, where the
    first update lr g / (|g| + eps) turns a difference of g of 5e-9
    (falcon) or a few 1e-8 (zamba2) into 3e-5 to 9e-5 of the parameter:
    the step is, bit for bit, the port's AdamW on the port's gradient, and
    the port's AdamW on the reference's gradient gives the reference
    AdamW's parameters at 1e-5.  The gradient itself is held through mu.
    gemma3's are held so too: one of its wo gradients is -2.2e-8, and the
    packages' f32 values of it differ by 1.4e-9, which the first update
    turns into 1.6e-5 of the parameter."""
    cfg, tcfg, jp, tok, lab = model
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    topt = tadamw.AdamWConfig(**opt.__dict__)
    js = jadamw.init(jp)
    jp2, js2, jm = jstep.make_train_step(cfg, opt, loss_chunk=CHUNK)(
        jp, js, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)})
    tp = _tp(jp)
    ts = tadamw.init(tp)
    step = tstep.make_train_step(tcfg, topt, loss_chunk=CHUNK)
    tp2, ts2, tm = step(tp, ts, {"tokens": torch.from_numpy(tok),
                                 "labels": torch.from_numpy(lab).long()})
    held = [(ts2.mu, js2.mu), (ts2.nu, js2.nu)]
    if tcfg.name == "qwen3-1.7b-smoke":
        held.append((tp2, jp2))
    else:
        tp = _tp(jp)
        named, rebuild = flatten_named(tp)
        leaves = [p.requires_grad_() for _, p in named]
        loss = tlm.lm_loss(tcfg, tp, torch.from_numpy(tok),
                           torch.from_numpy(lab), loss_chunk=CHUNK)
        grads = rebuild(list(torch.autograd.grad(loss, leaves)))
        with torch.no_grad():
            got, _, _ = tadamw.update(topt, grads, tadamw.init(tp), tp)
        for (name, a), (_, b) in zip(_named(got), _named(tp2)):
            assert torch.equal(a, b), name
        jgrads = jax.grad(lambda p: jlm.lm_loss(
            cfg, p, jnp.asarray(tok), jnp.asarray(lab),
            loss_chunk=CHUNK))(jp)
        want, _, _ = jadamw.update(opt, jgrads, jadamw.init(jp), jp)
        tp = _tp(jp)
        got, _, _ = tadamw.update(topt, _tp(jgrads), tadamw.init(tp), tp)
        held.append((got, want))
    tol = dict(rtol=1e-5, atol=1e-5)
    for tree, want in held:
        w = dict(_named(jax.tree_util.tree_map(np.asarray, want)))
        for name, t in _named(tree):
            np.testing.assert_allclose(t.detach().numpy(), w[name],
                                       err_msg=name, **tol)
    assert int(ts2.count) == int(js2.count) == 1
    # zamba2's global gradient norm: the two packages' f32 values meet at
    # 1.2e-5 relative (the hybrid's f32 gradients differ by up to GRAD_REL,
    # 2e-4, in tests/test_torch_hybrid.py)
    norm_tol = dict(tol, rtol=2e-5) if tcfg.family == "hybrid" else tol
    for k, t in (("loss", tol), ("grad_norm", norm_tol), ("lr", tol)):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **t)


def test_per_layer_cast_equals_the_cast_once_serve_path(model):
    """bf16 compute: forward_hidden on f32 master weights with remat (each
    layer's weights cast inside its checkpointed body) gives the bits of
    the serving forward on weights cast once."""
    import dataclasses
    _, tcfg, jp, tok, _ = model
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    master = _tp(jp)
    tok = torch.from_numpy(tok)
    with torch.no_grad():
        got, _ = tlm.forward_hidden(cfg, master, tok, remat=True)
        want, _ = tlm.forward_hidden(cfg, tlm.cast_params(master,
                                                          torch.bfloat16),
                                     tok)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
