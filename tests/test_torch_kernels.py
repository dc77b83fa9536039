"""The K1 flash-attention kernel's plain torch version against the JAX
package's Pallas kernel (interpret mode) and oracles, on the sweeps of
``tests/test_kernels.py``.  The CUDA kernel itself is held against the
plain version on the card by ``tests/test_torch_gpu.py``.

Inputs are made with numpy from a seed and handed to both packages.  The
Pallas kernel takes (B, H, S, D); the port's model layout is (B, S, H, D),
so its inputs and outputs are transposed here.  Tolerances are the
reference's own ``TOL`` (``test_kernels.py``): 2e-5 in f32, 2e-2 in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_kernel  # noqa: E402
from repro.models.layers import flash_attention as jax_flash  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BWD_HEAD_DIMS, HEAD_DIMS, flash_attention_bwd_cuda, flash_attention_cuda,
    flash_attention_plain)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(seed, B, H, Hkv, Sq, Skv, D, dtype="float32"):
    """(B, H, S, D) numpy inputs, the JAX arrays and the port's (B, S, H, D)
    tensors of them, all rounded to ``dtype`` identically."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, H, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    jdt, tdt = DTYPES[dtype]
    jx = [jnp.asarray(a).astype(jdt) for a in arrs]
    tx = [torch.from_numpy(a).to(tdt).transpose(1, 2) for a in arrs]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D", [
    (1, 1, 1, 8, 8, 4),
    (2, 4, 2, 16, 16, 8),       # GQA
    (1, 4, 4, 24, 16, 8),       # Sq != Skv (unaligned to blocks)
    (2, 8, 2, 8, 32, 16),       # long kv, group 4
    (1, 4, 4, 16, 16, 80),      # head dim 80 (zamba2), group 1
    (2, 4, 2, 12, 20, 80),      # head dim 80, GQA, Sq != Skv
    (1, 8, 4, 16, 16, 256),     # head dim 256 (gemma3), its group 2
    (2, 4, 2, 12, 20, 256),     # head dim 256, Sq != Skv
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_sweep(B, H, Hkv, Sq, Skv, D, dtype):
    (q, k, v), (tq, tk, tv) = _inputs(0, B, H, Hkv, Sq, Skv, D, dtype)
    want = flash_attention_kernel(q, k, v, causal=True, block_q=8, block_k=8,
                                  interpret=True)
    oracle = jref.flash_attention_ref(q, k, v, causal=True)
    got = flash_attention_plain(tq, tk, tv, causal=True, kv_chunk=8)
    assert got.dtype == DTYPES[dtype][1]
    got = _np(got.transpose(1, 2))
    np.testing.assert_allclose(got, _np(want), **TOL[dtype])
    np.testing.assert_allclose(got, _np(oracle), **TOL[dtype])


@pytest.mark.parametrize("causal,window", [(False, None), (True, 4),
                                           (False, 6)])
def test_plain_matches_pallas_kernel_masks(causal, window):
    (q, k, v), (tq, tk, tv) = _inputs(1, 1, 2, 2, 32, 32, 8)
    want = flash_attention_kernel(q, k, v, causal=causal, window=window or 0,
                                  block_q=8, block_k=8, interpret=True)
    got = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got.transpose(1, 2)), _np(want),
                               **TOL["float32"])


def test_plain_matches_pallas_kernel_window_at_head_dim_256():
    """gemma3's head dim and group, a sliding window over several blocks
    of the Pallas kernel and chunks of the plain version."""
    (q, k, v), (tq, tk, tv) = _inputs(11, 1, 8, 4, 32, 32, 256)
    want = flash_attention_kernel(q, k, v, causal=True, window=6,
                                  block_q=8, block_k=8, interpret=True)
    oracle = jref.flash_attention_ref(q, k, v, causal=True, window=6)
    got = _np(flash_attention_plain(tq, tk, tv, causal=True, window=6,
                                    kv_chunk=8).transpose(1, 2))
    np.testing.assert_allclose(got, _np(want), **TOL["float32"])
    np.testing.assert_allclose(got, _np(oracle), **TOL["float32"])


@pytest.mark.parametrize("q_offset,window,kv_chunk,Sq,Skv", [
    (0, None, 8, 16, 16),
    (5, None, 8, 3, 16),          # decode-style offset, Sq < Skv
    (15, None, 512, 1, 16),       # one-token decode at the last position
    (9, 4, 8, 1, 16),             # decode with a window
    (0, 3, 4, 16, 16),            # sliding window, several chunks
    (4, 1, 5, 6, 13),             # ragged chunks, window of one key
])
@pytest.mark.parametrize("offset_as_tensor", [False, True])
def test_plain_matches_model_attention(q_offset, window, kv_chunk, Sq, Skv,
                                       offset_as_tensor):
    """≡ the JAX model's chunked flash (``layers.flash_attention``)."""
    rng = np.random.default_rng(7)
    B, H, Hkv, D = 2, 4, 2, 8
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, window=window, kv_chunk=kv_chunk,
                     q_offset=jnp.int32(q_offset))
    off = torch.tensor(q_offset, dtype=torch.int32) if offset_as_tensor \
        else q_offset
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True,
                                window=window, kv_chunk=kv_chunk,
                                q_offset=off)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("q_offset,Sq,Skv", [
    (0, 16, 16),     # prefill
    (5, 3, 16),      # an offset
    (15, 1, 16),     # one-token decode at the last position
])
def test_plain_matches_model_attention_at_head_dim_80(q_offset, Sq, Skv):
    """Head dim 80 and one kv head a q head, as zamba2's shared attention
    has them, against the JAX model's chunked flash."""
    rng = np.random.default_rng(17)
    B, H, D = 2, 4, 80
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, Sq, H, D), (B, Skv, H, D), (B, Skv, H, D)))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, kv_chunk=8, q_offset=jnp.int32(q_offset))
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True, kv_chunk=8,
                                q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5)])
def test_ref_oracle_matches_jax_oracle(causal, window):
    (q, k, v), (tq, tk, tv) = _inputs(3, 2, 4, 2, 12, 20, 8)
    want = jref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = tref.flash_attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                                   tv.transpose(1, 2), causal=causal,
                                   window=window)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_fully_masked_rows_are_zero():
    _, (tq, tk, tv) = _inputs(4, 1, 2, 1, 4, 4, 8)
    out = flash_attention_plain(tq, tk, tv, causal=True, window=0)
    assert torch.count_nonzero(out) == 0


def test_dispatcher_runs_the_plain_version_on_cpu():
    _, (tq, tk, tv) = _inputs(5, 1, 4, 2, 10, 10, 16)
    before = flash_attention_cuda.launches
    got = ops.flash_attention(tq, tk, tv, causal=True, window=3, kv_chunk=4)
    want = flash_attention_plain(tq, tk, tv, causal=True, window=3)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert flash_attention_cuda.launches == before   # no kernel on the CPU


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "group", "stride",
                                 "window"])
def test_kernel_wrapper_validates_before_launch(bad, monkeypatch):
    """The wrapper's checks run on the host; shapes that the kernel does
    not take raise before anything is launched."""
    q = torch.zeros(1, 4, 4, 16)
    k = torch.zeros(1, 4, 2, 16)
    kw = {}
    if bad == "dtype":
        q, k = q.half(), k.half()
    elif bad == "head_dim":
        q, k = torch.zeros(1, 4, 4, 24), torch.zeros(1, 4, 2, 24)
    elif bad == "group":
        q, k = torch.zeros(1, 4, 128, 16), torch.zeros(1, 4, 1, 16)
    elif bad == "stride":
        q = torch.zeros(1, 4, 16, 4).transpose(2, 3)
    else:
        kw = dict(window=-1)
    # pretend the tensors are on the card so the checks after the device
    # check are reached; nothing may launch
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    before = flash_attention_cuda.launches
    with pytest.raises((ValueError, TypeError)):
        flash_attention_cuda(q, k, k, **kw)
    assert flash_attention_cuda.launches == before


@pytest.mark.parametrize("D,match", [
    (256, "window -1 < 0"),  # admitted: the next check refuses the window
    (72, "head dim 72"),     # no multiple of 16
    (512, "head dim 512"),   # no instantiation
])
@pytest.mark.parametrize("Sq", [1, 4])
def test_kernel_wrapper_admits_head_dim_256_and_refuses_others_before_launch(
        monkeypatch, D, match, Sq):
    """The forward kernels take head dim 256 (gemma3-4b), prefill and
    decode alike: at 256 the wrapper passes its head-dim checks and stops
    only at the negative window given here.  A head dim the kernels lack
    raises on the head dim.  Neither launches anything."""
    assert 256 in HEAD_DIMS and (D in HEAD_DIMS) == (D == 256)
    q = torch.zeros(1, Sq, 8, D, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 4, D, dtype=torch.bfloat16)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match=match):
        flash_attention_cuda(q, k, k, window=-1)
    assert flash_attention_cuda.launches == before


def test_gradient_at_head_dim_512_raises_before_the_forward(monkeypatch):
    """With q, k or v requiring grad at a head dim the backward lacks
    (512), ops.flash_attention raises naming the head dim before the
    forward kernel would launch, and nothing falls back."""
    assert 512 not in BWD_HEAD_DIMS
    q = torch.zeros(1, 4, 8, 512, dtype=torch.bfloat16, requires_grad=True)
    k = torch.zeros(1, 4, 4, 512, dtype=torch.bfloat16)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    f0, b0 = flash_attention_cuda.launches, flash_attention_bwd_cuda.launches
    with pytest.raises(ValueError, match="head dim 512"):
        ops.flash_attention(q, k, k)
    assert flash_attention_cuda.launches == f0
    assert flash_attention_bwd_cuda.launches == b0


def test_gradient_at_head_dim_256_goes_to_the_autograd_function(monkeypatch):
    """At head dim 256 (gemma3-4b) a gradient is admitted: with q
    requiring grad on the card, ops.flash_attention hands q, k, v and the
    masks to FlashAttentionFunction (K1's forward with its log-sum-exp,
    then its backward kernels), as at any head dim the backward takes."""
    q = torch.zeros(1, 4, 8, 256, dtype=torch.bfloat16, requires_grad=True)
    k = torch.zeros(1, 4, 4, 256, dtype=torch.bfloat16)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    calls = []
    monkeypatch.setattr(ops.FlashAttentionFunction, "apply",
                        lambda *args: calls.append(args) or "applied")
    assert ops.flash_attention(q, k, k, window=1024, q_offset=3) == "applied"
    (args,) = calls
    assert args[0] is q and args[1] is k and args[2] is k
    assert args[3:] == (True, 1024, 3)


@pytest.mark.parametrize("D,match", [
    (80, "lse must be"),     # admitted: the next check refuses the bad lse
    (256, "lse must be"),    # gemma3-4b's: admitted as well
    (72, "head dim 72"),     # no multiple of 16
    (512, "head dim 512"),   # no instantiation
])
def test_backward_wrapper_admits_head_dim_80_and_refuses_others_before_launch(
        monkeypatch, D, match):
    """The backward kernels take head dims 80 (zamba2) and 256 (gemma3):
    there the wrapper passes its head-dim checks and stops only at the
    malformed lse given here.  A head dim the kernels lack raises on the
    head dim.  Neither launches anything."""
    assert (D in BWD_HEAD_DIMS) == (D in (80, 256))
    q = torch.zeros(1, 4, 2, D, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 5)   # Sq is 4
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    before = flash_attention_bwd_cuda.launches
    with pytest.raises(ValueError, match=match):
        flash_attention_bwd_cuda(q, q, q, q, q, lse)
    assert flash_attention_bwd_cuda.launches == before


def test_backward_wrapper_refuses_an_f32_group_over_32_at_head_dim_256(
        monkeypatch):
    """At head dim 256 the f32 dQ kernel's blocks hold 32 query rows of
    whole positions, so an f32 group over 32 raises before any launch;
    bf16 at 256 takes the group of 64 up to the checks after it."""
    k = torch.zeros(1, 4, 1, 256)
    lse = torch.zeros(1, 2, 5)   # malformed: the first check after the group's
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    before = flash_attention_bwd_cuda.launches
    for group, dtype, match in ((64, torch.float32, "group of at most 32"),
                                (32, torch.float32, "lse must be"),
                                (64, torch.bfloat16, "lse must be")):
        q = torch.zeros(1, 4, group, 256, dtype=dtype)
        with pytest.raises(ValueError, match=match):
            flash_attention_bwd_cuda(q, k.to(dtype), k.to(dtype), q, q, lse)
    assert flash_attention_bwd_cuda.launches == before
