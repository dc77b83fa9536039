"""The port's serving slice end to end on the CPU, against the JAX package:
JAX saves the smoke qwen3 weights to scda, the port restores them and
serves a batch greedily; its tokens equal those of the same loop run in
JAX (``examples/serve_decode.py``'s loop), with per-step logits within
1e-4.  The reverse direction (port save → JAX restore) is held too."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore as jax_restore  # noqa: E402
from repro.checkpoint import save as jax_save  # noqa: E402
from repro.configs import get_config, smoke  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_lm as jax_init_lm  # noqa: E402
from repro.models import serve_step as jax_serve_step  # noqa: E402

from repro_torch import serve  # noqa: E402
from repro_torch.checkpoint import save as torch_save  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import smoke as tsmoke  # noqa: E402
from repro_torch.models import init_lm as torch_init_lm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, PROMPT, GEN, MAX_LEN = 3, 6, 10, 24


def _jax_loop(cfg, params, prompts):
    """The JAX example's loop: prompt token by token, then greedy."""
    cache = jax_init_cache(cfg, BATCH, MAX_LEN)
    step = jax.jit(lambda p, c, t: jax_serve_step(cfg, p, c, t))
    logits_seq = []
    for i in range(PROMPT):
        logits, cache = step(params, cache, prompts[:, i:i + 1])
        logits_seq.append(np.asarray(logits))
    out = []
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    for _ in range(GEN):
        out.append(np.asarray(tok))
        logits, cache = step(params, cache, tok)
        logits_seq.append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    return np.concatenate(out, 1), logits_seq


def _torch_loop(tcfg, weights, prompts):
    seen = {}
    with torch.inference_mode():
        out = serve.generate(tcfg, weights, torch.from_numpy(prompts), GEN,
                             max_len=MAX_LEN,
                             on_step=lambda i, lg: seen.__setitem__(
                                 i, lg.numpy().copy()))
    return out, [seen[i] for i in range(PROMPT + GEN)]


@pytest.fixture(scope="module")
def setup():
    cfg = smoke(get_config("qwen3-1.7b"))
    tcfg = tsmoke(tget("qwen3-1.7b"))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    return cfg, tcfg, prompts


@pytest.mark.parametrize("compressed", [False, True])
def test_jax_checkpoint_served_by_the_port(tmp_path, setup, compressed):
    cfg, tcfg, prompts = setup
    params = jax_init_lm(cfg, jax.random.PRNGKey(0))
    path = str(tmp_path / "w.scda")
    jax_save(path, params, step=1000, compressed=compressed)

    like = torch_init_lm(tcfg, 0, device="cpu")   # structure only
    weights, step = serve.load_weights(tcfg, path, like, device="cpu")
    assert step == 1000
    out, t_logits = _torch_loop(tcfg, weights, prompts)
    j_tokens, j_logits = _jax_loop(cfg, params, jnp.asarray(prompts))

    np.testing.assert_array_equal(out["tokens"].numpy(), j_tokens)
    assert out["tokens"].dtype == torch.int32
    for i, (a, b) in enumerate(zip(t_logits, j_logits)):
        np.testing.assert_allclose(a, b, err_msg=f"step {i}", **TOL)
    np.testing.assert_allclose(out["prompt_logits"].numpy(),
                               j_logits[PROMPT - 1], **TOL)
    assert int(out["cache"]["pos"]) == PROMPT + GEN


def test_port_checkpoint_served_by_jax(tmp_path, setup):
    cfg, tcfg, prompts = setup
    weights = torch_init_lm(tcfg, 5, device="cpu")
    path = str(tmp_path / "w.scda")
    torch_save(path, weights, step=3)
    like = jax.eval_shape(lambda: jax_init_lm(cfg, jax.random.PRNGKey(0)))
    jparams, step = jax_restore(path, like=like)
    assert step == 3
    out, t_logits = _torch_loop(tcfg, weights, prompts)
    j_tokens, j_logits = _jax_loop(cfg, jparams, jnp.asarray(prompts))
    np.testing.assert_array_equal(out["tokens"].numpy(), j_tokens)
    for i, (a, b) in enumerate(zip(t_logits, j_logits)):
        np.testing.assert_allclose(a, b, err_msg=f"step {i}", **TOL)


def test_serve_example_runs_on_the_cpu(capsys):
    out = serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "4", "--gen-len", "5",
                      "--max-len", "16"])
    assert tuple(out["tokens"].shape) == (2, 5)
    text = capsys.readouterr().out
    assert "restored step=1000" in text and "tok/s on cpu" in text


def test_generate_rejects_an_overlong_request(setup):
    _, tcfg, prompts = setup
    weights = torch_init_lm(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        serve.generate(tcfg, weights, torch.from_numpy(prompts), MAX_LEN,
                       max_len=MAX_LEN)
