"""The PyTorch port's dense model against the JAX package's, on the smoke
configs (f32, CPU): the same weights (JAX ``init_lm`` → numpy →
``params_from_numpy``) and the same token ids give the same logits
within 1e-4, for the full forward, for cached decode steps and for the
prefill step.  Every arch of the registry, each family, passes the port
of ``tests/test_archs.py``'s three checks."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import step as jstep  # noqa: E402

from repro_torch.checkpoint.pytree_io import flatten_named  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import smoke as tsmoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
DENSE = ["qwen3-1.7b", "gemma3-4b", "yi-6b", "nemotron-4-15b"]
B = 2


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    arch = request.param
    cfg = smoke(get_config(arch))
    tcfg = tsmoke(tget(arch))
    jp = jlm.init_lm(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return cfg, tcfg, jp, tp


def _tokens(cfg, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def test_forward_matches_jax(model):
    cfg, tcfg, jp, tp = model
    tok = _tokens(cfg, 12)
    want = jlm.forward(cfg, jp, jnp.asarray(tok))
    got = tlm.forward(tcfg, tp, torch.from_numpy(tok))
    assert got.shape == (B, 12, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_serve_steps_match_jax(model):
    cfg, tcfg, jp, tp = model
    tok = _tokens(cfg, 8, seed=1)
    jcache = jlm.init_cache(cfg, B, 16)
    tcache = tlm.init_cache(tcfg, B, 16, device="cpu")
    step = jax.jit(lambda p, c, t: jlm.serve_step(cfg, p, c, t))
    for i in range(8):
        jl, jcache = step(jp, jcache, jnp.asarray(tok[:, i:i + 1]))
        tl, tcache = tlm.serve_step(tcfg, tp, tcache,
                                    torch.from_numpy(tok[:, i:i + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert int(tcache["pos"]) == i + 1
    # the in-place cache holds what the functional one does
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]),
                               **TOL)


def test_prefill_step_matches_jax(model):
    cfg, tcfg, jp, tp = model
    tok = _tokens(cfg, 10, seed=2)
    want = jstep.make_prefill_step(cfg)(jp, {"tokens": jnp.asarray(tok)})
    got = tstep.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_matches_prefill(model):
    """Step-by-step decode agrees with the parallel forward (as the JAX
    package's ``test_archs.py`` checks for its own model)."""
    cfg, tcfg, _, tp = model
    tok = torch.from_numpy(_tokens(cfg, 8, seed=3))
    ref = tlm.forward(tcfg, tp, tok)
    cache = tlm.init_cache(tcfg, B, 8, device="cpu")
    serve = tstep.make_serve_step(tcfg)
    outs = []
    for i in range(8):
        logits, cache = serve(tp, cache, tok[:, i:i + 1])
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_layers_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = (rng.standard_normal(16) * 0.1).astype(np.float32)
    pos = np.arange(5)[None].repeat(2, 0).astype(np.int32) + 3
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    np.testing.assert_allclose(
        TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)), **TOL)
    h = rng.standard_normal((2, 5, 8)).astype(np.float32)
    for mlp_type in ("swiglu", "geglu", "relu2", "gelu"):
        jp = JL.init_mlp(jax.random.PRNGKey(1), 8, 12, mlp_type, jnp.float32)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        np.testing.assert_allclose(
            TL.mlp_block(tp, torch.from_numpy(h), mlp_type).numpy(),
            np.asarray(JL.mlp_block(jp, jnp.asarray(h), mlp_type)), **TOL)


def test_weights_are_cast_once():
    cfg = tsmoke(tget("qwen3-1.7b"))
    params = tlm.init_lm(cfg, 0, device="cpu")
    bf = tlm.cast_params(params, torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in (
        bf["embed"], bf["layers"]["attn"]["wq"], bf["layers"]["ln1"]))
    assert tlm.cast_params(bf, torch.bfloat16)["embed"] is bf["embed"]
    tok = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="cast_params"):
        tlm.forward(cfg, bf, tok)   # the smoke config computes in f32
    bf16_cfg = tget("qwen3-1.7b").__class__(**{
        **cfg.__dict__, "dtype": "bfloat16"})
    with pytest.raises(ValueError, match="cast_params"):
        tlm.forward(bf16_cfg, params, tok)
    assert tlm.forward(bf16_cfg, bf, tok).shape == (1, 4, cfg.vocab)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m",
                                  "llama4-scout-17b-a16e", "whisper-medium",
                                  "llava-next-mistral-7b"])
def test_init_lm_is_seeded_and_shaped_like_the_reference(arch):
    """The tree's keys and shapes are the reference's (an moe model's
    stacked experts and llama4-scout's shared expert, whisper's encoder
    and cross-attention, llava's mm_proj too), and a seed gives the same
    weights twice."""
    cfg = smoke(get_config(arch))
    tcfg = tsmoke(tget(arch))
    a = tlm.init_lm(tcfg, 3, device="cpu")
    b = tlm.init_lm(tcfg, 3, device="cpu")
    ref = jax.eval_shape(lambda: jlm.init_lm(cfg, jax.random.PRNGKey(0)))
    flat_ref = {jax.tree_util.keystr(p): v.shape for p, v in
                jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_flatten_with_path(a)[0]}
    assert flat == flat_ref
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])


# ------------------------------------------- every arch (tests/test_archs.py) --
ARCHS = sorted(REGISTRY)


def _inputs(tcfg, S, seed=0):
    """Tokens (B, S) and the family's other inputs, from a numpy seed."""
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, tcfg.vocab, (B, S))
                           .astype(np.int32))
    kw = {}
    if tcfg.family == "vlm":
        kw["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, tcfg.num_patches, tcfg.d_model)).astype(np.float32))
    if tcfg.family == "encdec":
        kw["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, tcfg.max_source_len, tcfg.d_model)).astype(np.float32))
    return tok, kw


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_forward_shapes_and_finite(arch):
    """The port of tests/test_archs.py's forward check: every arch's smoke
    config gives finite logits of the right shape (a vlm's over its image
    prefix and its text)."""
    tcfg = tsmoke(tget(arch))
    params = tlm.init_lm(tcfg, 0, device="cpu")
    tok, kw = _inputs(tcfg, 16)
    with torch.no_grad():
        logits = tlm.forward(tcfg, params, tok, **kw)
    S_out = 16 + (tcfg.num_patches if tcfg.family == "vlm" else 0)
    assert tuple(logits.shape) == (B, S_out, tcfg.vocab)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_train_gradient_step(arch):
    """The port of tests/test_archs.py's gradient check: a finite loss
    near a uniform guess's, finite gradients, a nonzero gradient norm."""
    tcfg = tsmoke(tget(arch))
    params = tlm.init_lm(tcfg, 0, device="cpu")
    tok, kw = _inputs(tcfg, 16, seed=1)
    labels = torch.roll(tok, -1, dims=1)
    named = flatten_named(params)[0]
    leaves = [p.requires_grad_() for _, p in named]
    loss = tlm.lm_loss(tcfg, params, tok, labels, loss_chunk=8, **kw)
    grads = torch.autograd.grad(loss, leaves)
    assert 0.0 < loss.item() < 3 * np.log(tcfg.vocab)
    assert all(torch.isfinite(g).all() for g in grads)
    assert sum(g.square().sum() for g in grads).item() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_decode_steps(arch):
    """The port of tests/test_archs.py's decode check: 3 greedy steps give
    finite logits and advance the position (an encdec model's cache holds
    random encoder output, as the reference's check fills it)."""
    tcfg = tsmoke(tget(arch))
    params = tlm.init_lm(tcfg, 0, device="cpu")
    cache = tlm.init_cache(tcfg, B, 32, device="cpu")
    if tcfg.family == "encdec":
        cache["enc_out"].copy_(torch.randn(cache["enc_out"].shape,
                                           generator=torch.Generator()
                                           .manual_seed(0)))
    tok = torch.zeros((B, 1), dtype=torch.int32)
    with torch.inference_mode():
        for i in range(3):
            logits, cache = tlm.serve_step(tcfg, params, cache, tok)
            assert tuple(logits.shape) == (B, tcfg.vocab)
            assert torch.isfinite(logits).all()
            assert int(cache["pos"]) == i + 1
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)


def test_every_family_is_ported():
    families = {tget(arch).family for arch in ARCHS}
    assert families == set(tlm.FAMILIES)
    with pytest.raises(ValueError, match="unknown family"):
        tlm.init_lm(dataclasses.replace(tsmoke(tget(ARCHS[0])),
                                        family="rnn"), 0, device="cpu")
