"""The K1 decode kernel's arithmetic on the CPU: split-KV partials merged in
split order (``flash_attention_split_plain``) against the JAX model's
attention (``repro.models.layers.flash_attention``) and the reference
oracle (``repro.kernels.ref.flash_attention_ref``), and the decode plan
that fixes the kernel's grid and scratch.  The CUDA kernel itself is held
against the plain versions on the card by ``tests/test_torch_gpu.py``.

Inputs are made with numpy from a seed and handed to both packages.  The
cache holds 150 keys, not a multiple of the 64-key split, and the
positions sit on both sides of split boundaries.  Tolerance: the
reference's own f32 ``TOL`` (``test_kernels.py``), 2e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models.layers import flash_attention as jax_flash  # noqa: E402

from repro_torch.kernels.flash_attention import (  # noqa: E402
    DECODE_SPLIT, decode_plan, flash_attention_plain,
    flash_attention_split_plain)

TOL = dict(rtol=2e-5, atol=2e-5)
SKV = 150
POSITIONS = (0, 63, 64, 127, 128)
GROUPS = (1, 2, 16)


def _decode_inputs(seed, group, Hkv=2, B=2, D=16, Skv=SKV):
    """(B, 1, H, D) query and (B, Skv, Hkv, D) cache, f32 numpy."""
    rng = np.random.default_rng(seed)
    H = Hkv * group
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, 1, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("window", [None, 50])
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("pos", POSITIONS)
def test_split_plain_matches_model_attention(pos, group, window):
    """≡ the JAX model's chunked flash at a decode position; a window of 50
    crosses the split boundary at 64 for every position past it."""
    q, k, v = _decode_inputs(pos * 7 + group, group)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, window=window, q_offset=jnp.int32(pos))
    off = torch.tensor(pos, dtype=torch.int32)
    got = flash_attention_split_plain(*_t(q, k, v), causal=True,
                                      window=window, q_offset=off)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0), (False, 30)])
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("pos", POSITIONS)
def test_split_plain_matches_reference_oracle(pos, group, causal, window):
    """≡ row ``pos`` of the oracle's full (B, H, Skv, D) attention, whose
    window is 0 to disable it."""
    rng = np.random.default_rng(pos * 11 + group)
    B, Hkv, D = 2, 2, 16
    H = Hkv * group
    qf, k, v = (rng.standard_normal(s).astype(np.float32) for s in
                ((B, H, SKV, D), (B, Hkv, SKV, D), (B, Hkv, SKV, D)))
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(qf), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))[:, :, pos]
    q, k_, v_ = (torch.from_numpy(a).transpose(1, 2) for a in
                 (qf[:, :, pos:pos + 1], k, v))
    got = flash_attention_split_plain(q, k_, v_, causal=causal,
                                      window=window or None, q_offset=pos)
    np.testing.assert_allclose(got[:, 0].numpy(), want, **TOL)


@pytest.mark.parametrize("split", [16, DECODE_SPLIT, 128])
@pytest.mark.parametrize("pos,window", [(0, None), (100, 50), (149, 7),
                                        (30, 0)])
def test_split_plain_independent_of_the_split(pos, window, split):
    """The split size changes only the order of the sums."""
    q, k, v = _t(*_decode_inputs(5, 2))
    got = flash_attention_split_plain(q, k, v, window=window, q_offset=pos,
                                      split=split)
    want = flash_attention_plain(q, k, v, window=window, q_offset=pos)
    torch.testing.assert_close(got, want, **TOL)


def test_split_plain_with_no_live_key_is_zero():
    q, k, v = _t(*_decode_inputs(6, 2))
    out = flash_attention_split_plain(q, k, v, window=0, q_offset=100)
    assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("pos", POSITIONS)
def test_split_plain_bf16(pos):
    """In bf16, p rounds against each split's own max, not the running
    max: within the reference's bf16 tolerance of the plain version."""
    q, k, v = (t.to(torch.bfloat16) for t in _t(*_decode_inputs(pos, 2)))
    got = flash_attention_split_plain(q, k, v, q_offset=pos, window=50)
    want = flash_attention_plain(q, k, v, q_offset=pos, window=50)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("split", [64, 128])
@pytest.mark.parametrize("Skv", [1, 63, 64, 65, 127, 128, 150, 1024])
def test_decode_plan_covers_every_key_once(Skv, split):
    plan = decode_plan(Skv, split, B=3, Hkv=2, group=4, D=32)
    seen = np.zeros(Skv, dtype=int)
    for lo, hi in plan.key_ranges:
        assert lo < hi            # no split is empty for the capacity
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert plan.n_splits == -(-Skv // split) == len(plan.key_ranges)
    assert plan.grid == (plan.n_splits, 2, 3)
    assert plan.tickets == 3 * 2
    assert plan.scratch_floats == 3 * 2 * plan.n_splits * 4 * (32 + 2)


def test_decode_plan_refuses_an_empty_cache():
    with pytest.raises(ValueError):
        decode_plan(0)
