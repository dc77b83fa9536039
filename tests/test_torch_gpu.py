"""The port on the card: the K1 CUDA kernel against its plain version, the
smoke model on CUDA against the same model on the CPU, and a checkpoint
round trip of CUDA tensors.  Every test here needs a GPU and skips
without one; none imports JAX, so the file runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_plain)

pytestmark = pytest.mark.gpu

#: kernel vs plain version: tests/test_kernels.py's TOL for the dtype.
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the K1 kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal,window,q_offset", [
    (2, 4, 2, 16, 16, 16, True, None, 0),
    (1, 8, 2, 70, 70, 128, True, None, 0),      # ragged tiles, group 4
    (1, 4, 2, 20, 100, 32, False, None, 0),     # non-causal
    (2, 4, 4, 130, 130, 64, True, 16, 0),       # sliding window
    (3, 16, 8, 1, 300, 128, True, None, 157),   # decode against a cache
    (2, 4, 2, 5, 40, 32, True, 8, 30),          # offset and window
    (1, 2, 1, 8, 8, 64, True, 0, 0),            # empty window: zeros
])
def test_kernel_matches_plain(cuda, dtype, B, H, Hkv, Sq, Skv, D, causal,
                              window, q_offset):
    rng = np.random.default_rng(Sq * 131 + Skv)
    q = _rand(rng, (B, Sq, H, D), dtype, cuda)
    k = _rand(rng, (B, Skv, Hkv, D), dtype, cuda)
    v = _rand(rng, (B, Skv, Hkv, D), dtype, cuda)
    off = torch.tensor(q_offset, dtype=torch.int32, device=cuda)
    before = flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 q_offset=off)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_kernel_reads_the_offset_on_the_device(cuda):
    """The query offset is read by the kernel, not by the host: changing
    the device scalar in place changes the mask of the next launch."""
    rng = np.random.default_rng(1)
    q = _rand(rng, (1, 1, 2, 64), torch.float32, cuda)
    k = _rand(rng, (1, 32, 1, 64), torch.float32, cuda)
    pos = torch.tensor(3, dtype=torch.int32, device=cuda)
    a = flash_attention_cuda(q, k, k, q_offset=pos)
    pos.fill_(20)
    b = flash_attention_cuda(q, k, k, q_offset=pos)
    for p, got in ((3, a), (20, b)):
        want = flash_attention_plain(q, k, k, q_offset=p)
        torch.testing.assert_close(got, want, **TOL[torch.float32])
    assert not torch.allclose(a, b)


def test_kernel_reads_strided_views(cuda):
    """The model's layout is read through strides: a per-layer slice of a
    stacked cache goes in without a copy."""
    rng = np.random.default_rng(2)
    cache = _rand(rng, (3, 2, 48, 2, 128), torch.bfloat16, cuda)
    q = _rand(rng, (2, 1, 4, 128), torch.bfloat16, cuda)
    off = torch.tensor(40, dtype=torch.int32, device=cuda)
    got = flash_attention_cuda(q, cache[1], cache[2], q_offset=off)
    want = flash_attention_plain(q, cache[1], cache[2], q_offset=off)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


def test_smoke_model_on_cuda_matches_cpu(cuda):
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import forward, init_cache, init_lm, serve_step
    cfg = smoke(get_config("qwen3-1.7b"))
    cpu = init_lm(cfg, 0, device="cpu")
    gpu = {k: v for k, v in _to(cpu, cuda).items()}
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    want = forward(cfg, cpu, tok)
    before = flash_attention_cuda.launches
    got = forward(cfg, gpu, tok.to(cuda))
    assert flash_attention_cuda.launches - before == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    c_cpu = init_cache(cfg, 2, 16, device="cpu")
    c_gpu = init_cache(cfg, 2, 16, device=cuda)
    for i in range(8):
        lc, c_cpu = serve_step(cfg, cpu, c_cpu, tok[:, i:i + 1])
        lg, c_gpu = serve_step(cfg, gpu, c_gpu, tok[:, i:i + 1].to(cuda))
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_checkpoint_round_trip_of_cuda_tensors(cuda, tmp_path):
    from repro_torch.checkpoint import restore, save
    rng = np.random.default_rng(4)
    tree = {"a": _rand(rng, (300, 7), torch.bfloat16, cuda),
            "b": {"c": _rand(rng, (5,), torch.float32, cuda)}, "n": 4}
    for compressed in (False, True):
        path = str(tmp_path / f"c{compressed}.scda")
        save(path, tree, step=9, compressed=compressed)
        got, step = restore(path, like=tree)
        assert step == 9 and got["n"] == 4
        assert got["a"].device.type == "cuda"
        assert torch.equal(got["a"].view(torch.int16),
                           tree["a"].view(torch.int16))
        assert torch.equal(got["b"]["c"], tree["b"]["c"])
