"""gemma3's attention in the port against the JAX package: the smoke config
at the full model's head dim (256) with its 5:1 local:global pattern, on the
CPU in f32.

gemma3-4b's own smoke config shrinks the head dim to 16 and makes every
other layer global; here 6 layers of head dim 256 with a window of 8 keys
over 24 tokens, so the five local layers mask keys 8 back and layer 5 is
global, as in the full model (``layer_is_global``).  The same weights (JAX
``init_lm`` → numpy → ``params_from_numpy``) and token ids go to both
packages: forward logits, the prefill step's and every decode step's
within 1e-4 of JAX's, and the decode steps within 1e-4 of JAX's forward.
Training, over 2 x 32 tokens, so the window masks in every local layer:
the loss and every gradient against ``jax.value_and_grad`` of the
reference's ``lm_loss``, with the port's remat on and off, and one train
step against the reference's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import step as jstep  # noqa: E402

from repro_torch.checkpoint.pytree_io import flatten_named  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import smoke as tsmoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
#: Training against JAX in f32: the same arithmetic, sums in another order.
#: The loss within LOSS_TOL; every gradient within GRAD_REL by relative L2
#: (the port's gradients lie 3e-6 or nearer); the train step's parameters,
#: AdamW moments and metrics within STEP_TOL.
LOSS_TOL = 1e-5
GRAD_REL = 1e-4
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_S, CHUNK = 32, 16
ARCH = "gemma3-4b"
GEMMA = dict(head_dim=256, attn_window=8, local_global_pattern=5,
             n_layers=6)
B, S = 2, 24


def _configs(**over):
    kw = {**GEMMA, **over}
    return (dataclasses.replace(smoke(get_config(ARCH)), **kw),
            dataclasses.replace(tsmoke(tget(ARCH)), **kw))


@pytest.fixture(scope="module")
def model():
    cfg, tcfg = _configs()
    jp = jlm.init_lm(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    return cfg, tcfg, jp, tp, tok


def test_config_has_gemma3s_attention(model):
    cfg, tcfg, _, tp, _ = model
    assert tcfg.head_dim_ == 256 and tcfg.n_heads // tcfg.n_kv_heads == 2
    assert [tcfg.layer_is_global(i) for i in range(6)] == [False] * 5 + [True]
    assert [cfg.layer_is_global(i) for i in range(6)] == \
        [tcfg.layer_is_global(i) for i in range(6)]
    assert tuple(tp["layers"]["attn"]["wq"].shape) == (6, 64, 4, 256)
    assert tlm._windows_per_layer(tcfg, S) == [8] * 5 + [S]


def test_forward_matches_jax(model):
    cfg, tcfg, jp, tp, tok = model
    want = jlm.forward(cfg, jp, jnp.asarray(tok))
    got = tlm.forward(tcfg, tp, torch.from_numpy(tok))
    assert got.shape == (B, S, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_window_masks(model):
    """The window changes the logits: without it (every layer global) the
    same weights give others from the ninth token on, and the same before."""
    _, tcfg, _, tp, tok = model
    _, full = _configs(attn_window=0, local_global_pattern=0)
    a = tlm.forward(tcfg, tp, torch.from_numpy(tok))
    b = tlm.forward(full, tp, torch.from_numpy(tok))
    torch.testing.assert_close(a[:, :8], b[:, :8], rtol=1e-5, atol=1e-5)
    assert (a[:, 8:] - b[:, 8:]).abs().amax() > 1e-2


def test_prefill_step_matches_jax(model):
    cfg, tcfg, jp, tp, tok = model
    want = jstep.make_prefill_step(cfg)(jp, {"tokens": jnp.asarray(tok)})
    got = tstep.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_matches_jax_and_the_forward(model):
    """24 decode steps into a cache of 32: each step's logits within 1e-4
    of JAX's step and of JAX's forward at that position, the caches
    equal."""
    cfg, tcfg, jp, tp, tok = model
    jcache = jlm.init_cache(cfg, B, 32)
    tcache = tlm.init_cache(tcfg, B, 32, device="cpu")
    step = jax.jit(lambda p, c, t: jlm.serve_step(cfg, p, c, t))
    serve = tstep.make_serve_step(tcfg)
    outs = []
    for i in range(S):
        jl, jcache = step(jp, jcache, jnp.asarray(tok[:, i:i + 1]))
        tl, tcache = serve(tp, tcache, torch.from_numpy(tok[:, i:i + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        outs.append(tl)
    assert int(tcache["pos"]) == S
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]),
                               **TOL)
    want = jlm.forward(cfg, jp, jnp.asarray(tok))
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), np.asarray(want),
                               **TOL)


# ----------------------------------------------------------------- training --
def _tp(jp):
    """Fresh port leaves of the reference's parameters."""
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


@pytest.fixture(scope="module")
def batch(model):
    cfg = model[0]
    seq = np.random.default_rng(1).integers(
        0, cfg.vocab, (B, TRAIN_S + 1)).astype(np.int32)
    return seq[:, :-1], seq[:, 1:]


@pytest.fixture(scope="module")
def jax_loss_and_grads(model, batch):
    cfg, _, jp, _, _ = model
    tok, lab = batch
    loss, grads = jax.value_and_grad(lambda p: jlm.lm_loss(
        cfg, p, jnp.asarray(tok), jnp.asarray(lab), loss_chunk=CHUNK))(jp)
    return float(loss), dict(_named(jax.tree_util.tree_map(np.asarray,
                                                           grads)))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_gradients_match_jax(model, batch, jax_loss_and_grads,
                                      remat):
    """lm_loss at head dim 256 with the 5:1 windows (the window of 8 masks
    in layers 0-4 over 32 tokens) and every parameter's gradient, with
    the port's remat on and off, against jax.value_and_grad of the
    reference's lm_loss."""
    _, tcfg, jp, _, _ = model
    tok, lab = batch
    jloss, want = jax_loss_and_grads
    tp = _tp(jp)
    named = _named(tp)
    leaves = [p.requires_grad_() for _, p in named]
    loss = tlm.lm_loss(tcfg, tp, torch.from_numpy(tok),
                       torch.from_numpy(lab), loss_chunk=CHUNK, remat=remat)
    assert abs(loss.item() - jloss) <= LOSS_TOL
    grads = torch.autograd.grad(loss, leaves)
    assert sorted(want) == [name for name, _ in named]
    for (name, _), g in zip(named, grads):
        w = want[name]
        rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert rel <= GRAD_REL, f"{name}: relative L2 {rel}"


def test_train_step_matches_jax(model, batch):
    """One make_train_step step at head dim 256 with the windows against
    the reference's step: both AdamW moments (mu holds the gradient) and
    the metrics within STEP_TOL.  The parameters are held in two parts, as
    tests/test_torch_train.py holds falcon-mamba's, zamba2's and gemma3's:
    some gradients sit near AdamW's eps, where the first update lr g / (|g|
    + eps) turns a gradient difference in the last bits into 3e-5 of a
    parameter.  So the step is, bit for bit, the port's AdamW on the port's
    gradient, and the port's AdamW on the reference's gradient gives the
    reference AdamW's parameters within STEP_TOL."""
    cfg, tcfg, jp, _, _ = model
    tok, lab = batch
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    topt = tadamw.AdamWConfig(**opt.__dict__)
    jp2, js2, jm = jstep.make_train_step(cfg, opt, loss_chunk=CHUNK)(
        jp, jadamw.init(jp), {"tokens": jnp.asarray(tok),
                              "labels": jnp.asarray(lab)})
    tp = _tp(jp)
    tp2, ts2, tm = tstep.make_train_step(tcfg, topt, loss_chunk=CHUNK)(
        tp, tadamw.init(tp), {"tokens": torch.from_numpy(tok),
                              "labels": torch.from_numpy(lab).long()})
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
        cfg, p, jnp.asarray(tok), jnp.asarray(lab), loss_chunk=CHUNK))(jp)
    want, _, _ = jadamw.update(opt, jgrads, jadamw.init(jp), jp)
    tp = _tp(jp)
    got, _, _ = tadamw.update(topt, _tp(jgrads), tadamw.init(tp), tp)
    for tree, ref in ((got, want), (ts2.mu, js2.mu), (ts2.nu, js2.nu)):
        w = dict(_named(jax.tree_util.tree_map(np.asarray, ref)))
        for name, t in _named(tree):
            np.testing.assert_allclose(t.detach().numpy(), w[name],
                                       err_msg=name, **STEP_TOL)
    assert int(ts2.count) == int(js2.count) == 1
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **STEP_TOL)
