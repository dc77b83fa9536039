"""The PyTorch port's MoE family against the JAX package, on the CPU in f32.

The token-choice MoE block (``layers.moe_block``) against the reference's
for each MLP type, with a capacity that drops assignments, with a router
of zeros (every probability tied) and with llama4-scout's shared expert;
the top-k helper's tie order against ``jax.lax.top_k``; and the
granite-moe-3b-a800m smoke model (40 experts top-8 cut to 4 top-2):
forward logits, the prefill step, every serve step and the caches, the
loss with its aux term and every gradient with remat on and off, one
train step and its checkpoint bytes.  The same weights (JAX ``init_lm``
or ``init_moe`` → numpy → ``params_from_numpy``) and numpy-seeded inputs
go to both packages.

Tolerances: the block's output 1e-5 and its aux loss 1e-6; models 1e-4;
the loss 1e-5 and every gradient 1e-4 relative L2; the train step 1e-5
(as ``tests/test_torch_gemma.py``).  A decode step routes its B tokens
with the capacity of B tokens (1 slot an expert at B 2 here), so the
serve steps are held against JAX's serve steps, not against the forward.
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore as jax_restore  # noqa: E402
from repro.checkpoint import save as jax_save  # noqa: E402
from repro.configs import get_config, smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import step as jstep  # noqa: E402

from repro_torch import serve  # noqa: E402
from repro_torch.checkpoint import pytree_io as tio  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import smoke as tsmoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = 1e-5
GRAD_REL = 1e-4
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "granite-moe-3b-a800m"
B, S, TRAIN_S, CHUNK = 2, 12, 32, 16
#: The block's cases: (B, S, D), experts, top-k, d_ff.
D_MODEL, D_FF, N_EXP, TOP_K = 16, 24, 6, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke model's ops are tiny: one thread is several times faster
    than a pool shared with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tp(tree):
    """Fresh port leaves of a tree of the reference's arrays."""
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _block(mlp_type, shared=False, zero_router=False, seed=0):
    jp = JL.init_moe(jax.random.PRNGKey(seed), D_MODEL, D_FF, N_EXP,
                     mlp_type, shared, jnp.float32)
    if zero_router:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    x = np.random.default_rng(seed).standard_normal(
        (B, S, D_MODEL)).astype(np.float32)
    return jp, _tp(jp), x


def _jax_routing(jp, x, k, capacity_factor):
    """The reference's routing lines on ``x``: each assignment's expert, in
    (token, choice) order, and whether it is dropped."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax((xt @ jp["router"]).astype(jnp.float32), -1)
    _, ids = jax.lax.top_k(probs, k)
    E = jp["router"].shape[-1]
    C = max(1, int(capacity_factor * xt.shape[0] * k / E))
    flat = ids.reshape(-1)
    pos = jnp.take_along_axis(
        jnp.cumsum(jax.nn.one_hot(flat, E, dtype=jnp.int32), 0) - 1,
        flat[:, None], 1)[:, 0]
    return np.asarray(flat), np.asarray(pos >= C)


def _run_block(jp, tp, x, mlp_type, **kw):
    kw = dict(n_experts=N_EXP, top_k=TOP_K, mlp_type=mlp_type, **kw)
    jy, jaux = JL.moe_block(jp, jnp.asarray(x), **kw)
    ty, taux = TL.moe_block(tp, torch.from_numpy(x), **kw)
    return (ty.numpy(), float(taux)), (np.asarray(jy), float(jaux))


# -------------------------------------------------------------- the block --
@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "relu2", "gelu"])
def test_moe_block_matches_jax(mlp_type):
    jp, tp, x = _block(mlp_type)
    assert sorted(tp) == sorted(jp)
    (ty, taux), (jy, jaux) = _run_block(jp, tp, x, mlp_type)
    assert ty.shape == (B, S, D_MODEL)
    np.testing.assert_allclose(ty, jy, **BLOCK_TOL)
    np.testing.assert_allclose(taux, jaux, **AUX_TOL)


@pytest.mark.parametrize("mlp_type", ["swiglu", "relu2"])
def test_capacity_drops_the_assignments_jax_drops(mlp_type):
    """At capacity factor 0.5 an expert has int(0.5 T k / E) = 4 slots for
    48 assignments: some are dropped, the same ones as in the reference,
    and the block's output and aux loss still match."""
    jp, tp, x = _block(mlp_type, seed=1)
    flat, dropped = _jax_routing(jp, x, TOP_K, 0.5)
    r = TL.moe_route(tp["router"], torch.from_numpy(x).reshape(-1, D_MODEL),
                     top_k=TOP_K, capacity_factor=0.5)
    assert r.capacity == 4 and dropped.any()
    np.testing.assert_array_equal(r.ids.reshape(-1).numpy(), flat)
    np.testing.assert_array_equal((~r.keep).numpy(), dropped)
    (ty, taux), (jy, jaux) = _run_block(jp, tp, x, mlp_type,
                                        capacity_factor=0.5)
    np.testing.assert_allclose(ty, jy, **BLOCK_TOL)
    np.testing.assert_allclose(taux, jaux, **AUX_TOL)


def test_tied_router_routes_as_jax():
    """A router of zeros ties every probability: each token picks experts
    0 and 1, as jax.lax.top_k does, so experts 0 and 1 fill their slots in
    token order and drop the rest, as in the reference."""
    jp, tp, x = _block("swiglu", zero_router=True, seed=2)
    flat, dropped = _jax_routing(jp, x, TOP_K, 1.25)
    r = TL.moe_route(tp["router"], torch.from_numpy(x).reshape(-1, D_MODEL),
                     top_k=TOP_K)
    np.testing.assert_array_equal(r.ids.reshape(-1).numpy(), flat)
    assert (r.ids == torch.tensor([0, 1])).all()
    np.testing.assert_array_equal((~r.keep).numpy(), dropped)
    assert dropped.any()
    (ty, taux), (jy, jaux) = _run_block(jp, tp, x, "swiglu")
    np.testing.assert_allclose(ty, jy, **BLOCK_TOL)
    np.testing.assert_allclose(taux, jaux, **AUX_TOL)


@pytest.mark.parametrize("row,k", [
    ([0.1, 0.3, 0.3, 0.2, 0.3, 0.05], 3),
    ([0.25] * 4 + [0.0] * 36, 8),
    ([1.0] * 40, 8),
    ([0.5, 0.2, 0.5, 0.2, 0.1, 0.5, 0.2], 5),
])
def test_stable_top_k_breaks_ties_as_jax(row, k):
    x = np.asarray([row, row[::-1]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = TL.stable_top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n_tokens,want", [(2048, 512), (8192, 2048),
                                           (4, 1), (1, 1)])
def test_capacity_is_the_references(n_tokens, want):
    """granite's slots an expert (40 experts, top-8): a 4 x 512 prefill,
    an 8 x 1024 training step, a decode step of 4 requests, of 1."""
    assert TL.moe_capacity(n_tokens, 40, 8, 1.25) == want


def test_shared_expert_matches_jax():
    """llama4-scout's form: top-1 of the routed experts plus an always-on
    shared MLP, in the block and in the smoke model's forward."""
    jp, tp, x = _block("swiglu", shared=True, seed=3)
    assert sorted(tp["shared"]) == ["w_down", "w_gate", "w_up"]
    kw = dict(n_experts=N_EXP, top_k=1, mlp_type="swiglu",
              shared_expert=True)
    jy, jaux = JL.moe_block(jp, jnp.asarray(x), **kw)
    ty, taux = TL.moe_block(tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **BLOCK_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)
    arch = "llama4-scout-17b-a16e"
    cfg, tcfg = smoke(get_config(arch)), tsmoke(tget(arch))
    assert tcfg.shared_expert and tcfg.experts_top_k == 1
    jpm = jlm.init_lm(cfg, jax.random.PRNGKey(0))
    tok = np.random.default_rng(3).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    np.testing.assert_allclose(
        tlm.forward(tcfg, _tp(jpm), torch.from_numpy(tok)).numpy(),
        np.asarray(jlm.forward(cfg, jpm, jnp.asarray(tok))), **TOL)


# ------------------------------------------------------ the granite model --
@pytest.fixture(scope="module")
def model():
    cfg, tcfg = smoke(get_config(ARCH)), tsmoke(tget(ARCH))
    jp = jlm.init_lm(cfg, jax.random.PRNGKey(0))
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    return cfg, tcfg, jp, _tp(jp), tok


def test_granite_smoke_is_moe_in_every_layer(model):
    cfg, tcfg, _, tp, _ = model
    assert tcfg.family == "moe" and (tcfg.n_experts, tcfg.experts_top_k) \
        == (4, 2)
    assert sorted(tp["layers"]) == ["attn", "ln1", "ln2", "moe"]
    assert tuple(tp["layers"]["moe"]["w_up"].shape) == \
        (tcfg.n_layers, 4, tcfg.d_model, tcfg.d_ff)


def test_forward_matches_jax(model):
    cfg, tcfg, jp, tp, tok = model
    want = jlm.forward(cfg, jp, jnp.asarray(tok))
    got = tlm.forward(tcfg, tp, torch.from_numpy(tok))
    assert got.shape == (B, S, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _, jaux = jlm.forward_hidden(cfg, jp, jnp.asarray(tok))
    _, taux = tlm.forward_hidden(tcfg, tp, torch.from_numpy(tok))
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)


def test_prefill_step_matches_jax(model):
    cfg, tcfg, jp, tp, tok = model
    want = jstep.make_prefill_step(cfg)(jp, {"tokens": jnp.asarray(tok)})
    got = tstep.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_serve_steps_and_caches_match_jax(model):
    """12 decode steps into a cache of 16: each step's logits within 1e-4
    of JAX's serve_step and the caches equal.  A step routes 2 tokens with
    1 slot an expert, so it drops an assignment wherever the two tokens
    share an expert (some steps here do), as the reference's step does."""
    cfg, tcfg, jp, tp, tok = model
    jcache = jlm.init_cache(cfg, B, 16)
    tcache = tlm.init_cache(tcfg, B, 16, device="cpu")
    step = jax.jit(lambda p, c, t: jlm.serve_step(cfg, p, c, t))
    serve_step = tstep.make_serve_step(tcfg)
    drops = []
    real = TL.moe_route

    def route(*a, **kw):
        r = real(*a, **kw)
        drops.append(int((~r.keep).sum()))
        return r

    for i in range(S):
        jl, jcache = step(jp, jcache, jnp.asarray(tok[:, i:i + 1]))
        with mock.patch.object(TL, "moe_route", route):
            tl, tcache = serve_step(tp, tcache, torch.from_numpy(
                tok[:, i:i + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(tcache["pos"]) == S
    assert len(drops) == S * tcfg.n_layers and sum(drops) > 0
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)


def test_checkpoint_bytes_match_jax_and_restore_in_both(tmp_path, model):
    cfg, tcfg, jp, tp, tok = model
    ref, port = str(tmp_path / "ref.scda"), str(tmp_path / "port.scda")
    jax_save(ref, jp, step=7)
    tio.save(port, tp, step=7, vendor=tio.REFERENCE_VENDOR)
    with open(ref, "rb") as a, open(port, "rb") as b:
        assert a.read() == b.read()
    like = jax.eval_shape(lambda: jlm.init_lm(cfg, jax.random.PRNGKey(0)))
    got, step = jax_restore(port, like=like)
    assert step == 7
    for (n, g), (_, w) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                              jax.tree_util.tree_flatten_with_path(jp)[0]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(n))
    weights, step = serve.load_weights(
        tcfg, ref, tlm.init_lm(tcfg, 0, device="meta"), device="cpu")
    assert step == 7
    for (name, a), (_, b) in zip(_named(weights), _named(tp)):
        assert torch.equal(a, b), name
    np.testing.assert_allclose(
        tlm.forward(tcfg, weights, torch.from_numpy(tok)).numpy(),
        np.asarray(jlm.forward(cfg, jp, jnp.asarray(tok))), **TOL)


# ----------------------------------------------------------------- training --
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
    """lm_loss with its aux term (0.01 x the layers' summed load-balance
    loss) and every parameter's gradient, the router's through the gates
    and the aux loss, with the port's remat on and off, against
    jax.value_and_grad of the reference's lm_loss."""
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
    assert "layers/moe/router" in want
    for (name, _), g in zip(named, grads):
        w = want[name]
        rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert rel <= GRAD_REL, f"{name}: relative L2 {rel}"


def test_aux_weight_scales_the_aux_loss(model, batch):
    """The loss is the cross entropy plus aux_weight times the forward's
    aux, as the reference's: with aux_weight 0 both packages give the bare
    cross entropy, and the two weights differ by 0.01 x aux."""
    cfg, tcfg, jp, tp, _ = model
    tok, lab = batch
    with torch.no_grad():
        bare = tlm.lm_loss(tcfg, tp, torch.from_numpy(tok),
                           torch.from_numpy(lab), loss_chunk=CHUNK,
                           aux_weight=0.0)
        full = tlm.lm_loss(tcfg, tp, torch.from_numpy(tok),
                           torch.from_numpy(lab), loss_chunk=CHUNK)
        _, aux = tlm.forward_hidden(tcfg, tp, torch.from_numpy(tok))
    want = jlm.lm_loss(cfg, jp, jnp.asarray(tok), jnp.asarray(lab),
                       loss_chunk=CHUNK, aux_weight=0.0)
    assert abs(float(bare) - float(want)) <= LOSS_TOL
    np.testing.assert_allclose(float(full - bare), 0.01 * float(aux),
                               rtol=1e-4)


def test_train_step_matches_jax(model, batch):
    """One make_train_step step at capacity factor 1.0, where experts drop
    assignments of the 64 tokens: both AdamW moments and the metrics
    within STEP_TOL; the parameters in two parts, as
    tests/test_torch_gemma.py holds gemma3's (gradients near AdamW's eps):
    bit for bit the port's AdamW on the port's gradient, and the port's
    AdamW on the reference's gradient within STEP_TOL of the reference's
    step."""
    cfg, tcfg, jp, _, _ = model
    cfg = dataclasses.replace(cfg, capacity_factor=1.0)
    tcfg = dataclasses.replace(tcfg, capacity_factor=1.0)
    tok, lab = batch
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    topt = tadamw.AdamWConfig(**opt.__dict__)
    jp2, js2, jm = jstep.make_train_step(cfg, opt, loss_chunk=CHUNK)(
        jp, jadamw.init(jp), {"tokens": jnp.asarray(tok),
                              "labels": jnp.asarray(lab)})
    drops = []
    real = TL.moe_route

    def route(*a, **kw):
        r = real(*a, **kw)
        drops.append(int((~r.keep).sum()))
        return r

    tp = _tp(jp)
    with mock.patch.object(TL, "moe_route", route):
        tp2, ts2, tm = tstep.make_train_step(tcfg, topt, loss_chunk=CHUNK)(
            tp, tadamw.init(tp), {"tokens": torch.from_numpy(tok),
                                  "labels": torch.from_numpy(lab).long()})
    assert sum(drops) > 0
    tp = _tp(jp)
    named, rebuild = tio.flatten_named(tp)
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
