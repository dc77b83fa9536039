"""The PyTorch port's dense model against the JAX package's, on the smoke
configs (f32, CPU): the same weights (JAX ``init_lm`` → numpy →
``params_from_numpy``) and the same token ids give the same logits
within 1e-4, for the full forward, for cached decode steps and for the
prefill step."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import step as jstep  # noqa: E402

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
                                  "llama4-scout-17b-a16e"])
def test_init_lm_is_seeded_and_shaped_like_the_reference(arch):
    """The tree's keys and shapes are the reference's (an moe model's
    stacked experts and llama4-scout's shared expert too), and a seed
    gives the same weights twice."""
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


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b"])
def test_other_families_not_ported(arch):
    """Families not ported yet (encdec, vlm) raise."""
    cfg = tsmoke(tget(arch))
    with pytest.raises(NotImplementedError):
        tlm.init_lm(cfg, 0, device="cpu")
