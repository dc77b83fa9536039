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
    flash_attention_cuda, flash_attention_plain)

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
