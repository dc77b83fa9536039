"""gemma3's attention in the port against the JAX package: the smoke config
at the full model's head dim (256) with its 5:1 local:global pattern, on the
CPU in f32.

gemma3-4b's own smoke config shrinks the head dim to 16 and makes every
other layer global; here 6 layers of head dim 256 with a window of 8 keys
over 24 tokens, so the five local layers mask keys 8 back and layer 5 is
global, as in the full model (``layer_is_global``).  The same weights (JAX
``init_lm`` → numpy → ``params_from_numpy``) and token ids go to both
packages: forward logits, the prefill step's and every decode step's
within 1e-4 of JAX's, and the decode steps within 1e-4 of JAX's forward."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import step as jstep  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import smoke as tsmoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
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
