"""The port's optimizer, data pipeline and gradient compression against the
JAX package's, on the same numpy inputs (CPU, f32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticTokens as JTokens  # noqa: E402
from repro.distributed import grad_compress as jgc  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.distributed import grad_compress as tgc  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

#: The same f32 arithmetic in both packages; XLA may fuse a multiply-add
#: that torch rounds twice (one ulp, 6e-8 relative).
REL = dict(rtol=1e-6, atol=1e-8)
SHAPES = {"a": (5, 7), "b": {"c": (3,), "d": (2, 3, 4)}}


def _tree(rng, shapes=SHAPES, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, what):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, w, err_msg=what, **REL),
        _torch_np(got), _np(want))


def _torch_np(tree):
    if isinstance(tree, dict):
        return {k: _torch_np(v) for k, v in tree.items()}
    return tree.detach().numpy()


@pytest.mark.parametrize("cfg", [
    jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6),
    jadamw.AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=4,
                       weight_decay=0.0, clip_norm=0.0),
    jadamw.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=8,
                       clip_norm=0.5, b2=0.999),
])
def test_adamw_steps_match_jax(cfg):
    """Five steps of clipped AdamW: params, mu, nu and count, and the
    step's grad norm and lr, within 1e-6 relative of the reference."""
    tcfg = tadamw.AdamWConfig(**cfg.__dict__)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jadamw.init(jp)
    tp = params_from_numpy(p0, "cpu")
    ts = tadamw.init(tp)
    for step in range(5):
        g = _tree(rng, scale=2.0 ** (step - 2))
        jp, js, jstats = jadamw.update(
            cfg, jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp2, ts2, tstats = tadamw.update(tcfg, params_from_numpy(g, "cpu"),
                                         ts, tp)
        assert tp2 is tp and ts2 is ts           # updated in place
        _close(tp, jp, f"params, step {step}")
        _close(ts.mu, js.mu, f"mu, step {step}")
        _close(ts.nu, js.nu, f"nu, step {step}")
        assert ts.count.dtype == torch.int32 and ts.count.dim() == 0
        assert int(ts.count) == int(js.count) == step + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       **REL)


def test_update_frees_the_gradients():
    rng = np.random.default_rng(1)
    tp = params_from_numpy(_tree(rng), "cpu")
    grads = params_from_numpy(_tree(rng), "cpu")
    tadamw.update(tadamw.AdamWConfig(), grads, tadamw.init(tp), tp)
    assert grads == {"b": {}}


@pytest.mark.parametrize("cfg", [
    jadamw.AdamWConfig(warmup_steps=5, total_steps=20),
    jadamw.AdamWConfig(lr=1.0, warmup_steps=0, total_steps=7,
                       min_lr_ratio=0.0),
])
def test_schedule_matches_jax(cfg):
    tcfg = tadamw.AdamWConfig(**cfg.__dict__)
    for step in range(cfg.total_steps + 4):
        want = float(jadamw.schedule(cfg, jnp.asarray(step, jnp.int32)))
        got = float(tadamw.schedule(tcfg, torch.tensor(step,
                                                       dtype=torch.int32)))
        np.testing.assert_allclose(got, want, **REL)


def test_global_norm_matches_jax():
    tree = _tree(np.random.default_rng(2), scale=3.0)
    want = float(jadamw.global_norm(jax.tree_util.tree_map(jnp.asarray,
                                                           tree)))
    got = float(tadamw.global_norm(params_from_numpy(tree, "cpu")))
    np.testing.assert_allclose(got, want, **REL)


@pytest.mark.parametrize("step,row_start,rows", [(0, 0, 4), (3, 2, 5),
                                                 (17, 7, 1)])
def test_synthetic_tokens_match_jax(step, row_start, rows):
    kw = dict(vocab=300, seq_len=24, global_batch=8, seed=5)
    want = JTokens(JDataConfig(**kw)).global_batch_shard(step, row_start,
                                                         rows)
    got = SyntheticTokens(DataConfig(**kw)).global_batch_shard(
        step, row_start, rows)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])


def test_sharded_batch_is_the_global_batch_on_the_device():
    kw = dict(vocab=300, seq_len=24, global_batch=4, seed=2)
    want = JTokens(JDataConfig(**kw)).sharded_batch(6)
    got = SyntheticTokens(DataConfig(**kw)).sharded_batch(6, "cpu")
    assert got["tokens"].dtype == torch.int32
    assert got["labels"].dtype == torch.int64
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_sharded_batch_joins_extra_entries_as_the_reference_does():
    kw = dict(vocab=300, seq_len=24, global_batch=4, seed=2)
    frames = np.arange(4 * 5 * 3, dtype=np.float32).reshape(4, 5, 3)
    want = JTokens(JDataConfig(**kw)).sharded_batch(
        6, extra={"enc_embeds": jnp.asarray(frames)})
    got = SyntheticTokens(DataConfig(**kw)).sharded_batch(
        6, "cpu", extra={"enc_embeds": torch.from_numpy(frames)})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_grad_compression_matches_jax():
    rng = np.random.default_rng(3)
    params = _tree(rng)
    jr = jgc.init_error_feedback(jax.tree_util.tree_map(jnp.asarray, params))
    tr = tgc.init_error_feedback(params_from_numpy(params, "cpu"))
    for _ in range(3):
        g = _tree(rng)
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        tg = params_from_numpy(g, "cpu")
        np.testing.assert_equal(_torch_np(tgc.compress_grads(tg)),
                                _np(jgc.compress_grads(jg)))
        jsent, jr = jgc.compress_with_feedback(jg, jr)
        tsent, tr = tgc.compress_with_feedback(tg, tr)
        np.testing.assert_equal(_torch_np(tsent), _np(jsent))
        np.testing.assert_equal(_torch_np(tr), _np(jr))


def test_params_from_numpy_rebuilds_the_optimizer_state():
    """A JAX training state crosses over: its AdamWState becomes the
    port's, the 0-d count included."""
    params = jax.tree_util.tree_map(jnp.asarray,
                                    _tree(np.random.default_rng(4)))
    state = {"params": params, "opt": jadamw.init(params)}
    got = params_from_numpy(_np(state), "cpu")
    assert isinstance(got["opt"], tadamw.AdamWState)
    assert got["opt"].count.dtype == torch.int32
    assert got["opt"].count.dim() == 0
    np.testing.assert_equal(_torch_np(got["opt"].mu), _np(state["opt"].mu))
    np.testing.assert_equal(_torch_np(got["params"]), _np(params))
