"""The port on the card: the K1 kernels (prefill and split-KV decode, and
the backward) and the K2 kernels (the unfused scan, the fused scan and its
backward) against their plain versions, the smoke models (qwen3,
falcon-mamba, zamba2, gemma3, granite-moe, whisper, llava) on CUDA against
the same models on the CPU, their training paths (loss, gradients; kill
and resume for the first five),
and checkpoint round trips of CUDA tensors (flat, as a parity-protected
set without one of its shards, as a delta, and as DTensors saved by two
gloo ranks on the card and restored under another mesh).  Every
test here needs a GPU and skips without one; none imports JAX, so the
file runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BWD_LAUNCHES_PER_CALL, flash_attention_bwd_cuda, flash_attention_bwd_plain,
    flash_attention_cuda, flash_attention_plain, flash_attention_split_plain,
    lse_plain)
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    ssm_scan_cuda, ssm_scan_plain)

pytestmark = pytest.mark.gpu

#: kernel vs plain version: tests/test_kernels.py's TOL for the dtype.
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
#: K2 vs its plain version, whatever the input dtype: both read the inputs
#: as f32 and round the state identically; only the order of the sum over
#: n differs (tests/test_kernels.py's scan tolerance).
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
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
    (1, 4, 2, 200, 200, 128, True, 70, 0),      # window edge inside tiles
    (1, 4, 2, 100, 100, 64, False, 30, 0),      # non-causal window
    (1, 16, 1, 9, 9, 128, True, None, 0),       # group 16
    (1, 64, 1, 20, 20, 16, True, None, 0),      # group 64: a row per head
    (1, 6, 2, 50, 50, 32, True, None, 0),       # group 3 does not divide 64
    (2, 16, 8, 300, 300, 128, True, None, 0),   # qwen3's heads, 5 tiles
    (1, 4, 2, 1, 100, 64, False, None, 20),     # non-causal decode
    (2, 4, 1, 1, 1, 32, True, None, 0),         # decode, a one-key cache
    (2, 8, 8, 100, 100, 80, True, None, 0),     # head dim 80, group 1
    (1, 8, 2, 70, 70, 80, True, None, 0),       # head dim 80, group 4
    (1, 4, 4, 130, 130, 80, True, 16, 0),       # head dim 80, window
    (2, 32, 32, 1, 300, 80, True, None, 157),   # zamba2's decode heads
    (1, 8, 4, 100, 100, 256, True, None, 0),    # head dim 256, group 2
    (1, 32, 2, 70, 70, 256, True, None, 0),     # head dim 256, group 16
    (1, 8, 4, 200, 200, 256, True, 70, 0),      # head dim 256, window
    (2, 4, 2, 5, 40, 256, True, 8, 30),         # head dim 256, offset
    (2, 8, 4, 1, 300, 256, True, 100, 157),     # gemma3's decode, window
    (1, 24, 8, 70, 70, 64, True, None, 0),      # granite's heads, ragged
    (2, 24, 8, 130, 130, 64, True, None, 0),    # granite's heads, 3 tiles
    (2, 24, 8, 1, 300, 64, True, None, 157),    # granite's decode heads
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq", [(1, 1500), (1, 448), (2, 1)])
def test_kernel_at_whispers_unmasked_shapes(cuda, dtype, B, Sq):
    """whisper's attention without the causal mask, shrunk in batch, at
    its 16 / 16 heads of 64 over its 1500 source frames (the last 64-key
    tile or split ragged, 28 keys): the encoder's 1500 → 1500, the
    cross-attention's 448 → 1500 in a prefill and 1 → 1500 in a decode
    step, the query offset a host int as the model passes it."""
    rng = np.random.default_rng(Sq)
    q = _rand(rng, (B, Sq, 16, 64), dtype, cuda)
    k = _rand(rng, (B, 1500, 16, 64), dtype, cuda)
    v = _rand(rng, (B, 1500, 16, 64), dtype, cuda)
    before = flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if Sq == 1:
        want = flash_attention_split_plain(q, k, v, causal=False)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 50])
@pytest.mark.parametrize("group", [1, 2, 3, 16])
@pytest.mark.parametrize("pos", [0, 63, 64, 127, 128])
@pytest.mark.parametrize("D", [64, 80, 256])
def test_decode_kernel_at_split_boundaries(cuda, dtype, pos, group, window,
                                           D):
    """Decode against a 150-key cache (not a multiple of the 64-key split)
    on both sides of split boundaries; a window of 50 crosses one.  Held
    against both plain versions: the model's and the decode kernel's."""
    rng = np.random.default_rng(pos * 3 + group)
    B, Hkv = 2, 2
    q = _rand(rng, (B, 1, Hkv * group, D), dtype, cuda)
    k = _rand(rng, (B, 150, Hkv, D), dtype, cuda)
    v = _rand(rng, (B, 150, Hkv, D), dtype, cuda)
    off = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, window=window, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    for plain in (flash_attention_plain, flash_attention_split_plain):
        want = plain(q, k, v, window=window, q_offset=off)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_is_deterministic(cuda, dtype):
    """Two decode calls in a row give the same bits: the partials merge in
    split order, and the tickets are back at 0 after each launch."""
    rng = np.random.default_rng(8)
    q = _rand(rng, (4, 1, 16, 128), dtype, cuda)
    k = _rand(rng, (4, 1024, 8, 128), dtype, cuda)
    v = _rand(rng, (4, 1024, 8, 128), dtype, cuda)
    off = torch.tensor(1000, dtype=torch.int32, device=cuda)
    outs = [flash_attention_cuda(q, k, v, q_offset=off) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("H,Hkv,D", [(16, 8, 128), (32, 32, 80),
                                     (8, 4, 256), (24, 8, 64)])
def test_prefill_at_the_main_path_shape(cuda, H, Hkv, D):
    """The prefills of the served models, 4 x 512 in bf16: qwen3's 16 / 8
    heads of head dim 128, zamba2's 32 / 32 of head dim 80, gemma3's 8 / 4
    of head dim 256 and granite's 24 / 8 of head dim 64 (group 3)."""
    rng = np.random.default_rng(9)
    q = _rand(rng, (4, 512, H, D), torch.bfloat16, cuda)
    k = _rand(rng, (4, 512, Hkv, D), torch.bfloat16, cuda)
    v = _rand(rng, (4, 512, Hkv, D), torch.bfloat16, cuda)
    got = flash_attention_cuda(q, k, v)
    want = flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


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


@pytest.mark.parametrize("Sq", [1, 6])
def test_kernel_reads_strided_views(cuda, Sq):
    """The model's layout is read through strides: a per-layer slice of a
    stacked cache goes in without a copy, to either kernel, and so does a
    query sliced out of a wider projection."""
    rng = np.random.default_rng(2)
    cache = _rand(rng, (3, 2, 200, 2, 128), torch.bfloat16, cuda)
    q = _rand(rng, (2, Sq, 8, 128), torch.bfloat16, cuda)[:, :, 2:6]
    off = torch.tensor(140, dtype=torch.int32, device=cuda)
    got = flash_attention_cuda(q, cache[1], cache[2], q_offset=off)
    want = flash_attention_plain(q, cache[1], cache[2], q_offset=off)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("Sq", [1, 4])
def test_kernel_refuses_what_it_does_not_take(cuda, Sq):
    """Neither forward kernel takes fp16, head dim 512 or a group over 64:
    the wrapper raises before a launch, and nothing falls back."""
    z = lambda *s, dt=torch.bfloat16: torch.zeros(*s, dtype=dt, device=cuda)  # noqa
    before = flash_attention_cuda.launches
    with pytest.raises(TypeError):
        flash_attention_cuda(z(1, Sq, 2, 64, dt=torch.float16),
                             *[z(1, 8, 1, 64, dt=torch.float16)] * 2)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(z(1, Sq, 2, 512), *[z(1, 8, 1, 512)] * 2)
    with pytest.raises(ValueError, match="group"):
        flash_attention_cuda(z(1, Sq, 128, 64), *[z(1, 8, 1, 64)] * 2)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_cuda(z(1, Sq, 2, 64), *[z(1, 8, 1, 68)[..., :64]] * 2)
    assert flash_attention_cuda.launches == before


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


def test_gemma_attention_at_head_dim_256_on_cuda_matches_cpu(cuda):
    """gemma3's smoke config at head dim 256 with its 5:1 pattern (a window
    of 8 keys on layers 0-4, layer 5 global) over 24 tokens: the forward
    and 24 decode steps on the card, through K1 (6 launches each), against
    the same model on the CPU."""
    import dataclasses
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import forward, init_cache, init_lm, serve_step
    cfg = dataclasses.replace(smoke(get_config("gemma3-4b")), head_dim=256,
                              attn_window=8, local_global_pattern=5,
                              n_layers=6)
    cpu = init_lm(cfg, 0, device="cpu")
    gpu = _to(cpu, cuda)
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32))
    want = forward(cfg, cpu, tok)
    before = flash_attention_cuda.launches
    got = forward(cfg, gpu, tok.to(cuda))
    assert flash_attention_cuda.launches - before == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    c_cpu = init_cache(cfg, 2, 32, device="cpu")
    c_gpu = init_cache(cfg, 2, 32, device=cuda)
    for i in range(24):
        before = flash_attention_cuda.launches
        lc, c_cpu = serve_step(cfg, cpu, c_cpu, tok[:, i:i + 1])
        lg, c_gpu = serve_step(cfg, gpu, c_gpu, tok[:, i:i + 1].to(cuda))
        assert flash_attention_cuda.launches - before == cfg.n_layers
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)


def _granite_smoke():
    """granite's smoke config at granite's attention shape (group 3 of
    head dim 64: 6 / 2 heads) and its 4 experts, top-2."""
    import dataclasses
    from repro_torch.configs import get_config, smoke
    return dataclasses.replace(smoke(get_config("granite-moe-3b-a800m")),
                               n_heads=6, n_kv_heads=2, head_dim=64)


def test_granite_smoke_on_cuda_matches_cpu(cuda):
    """The granite smoke model on the card (K1 at D 64, group 3; the MoE
    block's routing, scatter and expert matmuls) against the CPU in f32:
    the forward and 12 decode steps within 1e-4, and the same assignments
    dropped in every MoE call (the decode steps route 2 tokens with 1 slot
    an expert)."""
    from unittest import mock
    from repro_torch.models import forward, init_cache, init_lm, serve_step
    from repro_torch.models import layers as L
    cfg = _granite_smoke()
    cpu = init_lm(cfg, 0, device="cpu")
    gpu = _to(cpu, cuda)
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    real = L.moe_route
    routes = {"cpu": [], "cuda": []}

    def route(*a, **kw):
        r = real(*a, **kw)
        routes[r.keep.device.type].append((r.ids.cpu(), r.keep.cpu()))
        return r

    with mock.patch.object(L, "moe_route", route):
        want = forward(cfg, cpu, tok)
        before = flash_attention_cuda.launches
        got = forward(cfg, gpu, tok.to(cuda))
        assert flash_attention_cuda.launches - before == cfg.n_layers
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        c_cpu = init_cache(cfg, 2, 16, device="cpu")
        c_gpu = init_cache(cfg, 2, 16, device=cuda)
        for i in range(12):
            lc, c_cpu = serve_step(cfg, cpu, c_cpu, tok[:, i:i + 1])
            lg, c_gpu = serve_step(cfg, gpu, c_gpu, tok[:, i:i + 1].to(cuda))
            torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    assert len(routes["cuda"]) == len(routes["cpu"]) == 13 * cfg.n_layers
    dropped = 0
    for (ids_c, keep_c), (ids_g, keep_g) in zip(routes["cpu"],
                                                routes["cuda"]):
        assert torch.equal(ids_c, ids_g) and torch.equal(keep_c, keep_g)
        dropped += int((~keep_c).sum())
    assert dropped > 0


def test_granite_smoke_loss_and_gradients_on_cuda_match_cpu(cuda):
    """lm_loss with its aux term and every leaf's gradient of the granite
    smoke model through K1's forward (twice a layer: remat) and its
    backward at D 64, group 3, against the same on the CPU."""
    from repro_torch.models import init_lm, lm_loss
    cfg = _granite_smoke()
    tok, lab = _smoke_batch(cfg)
    out = []
    for device in ("cpu", cuda):
        params = _to(init_lm(cfg, 0, device="cpu"), device)
        names = sorted(_leaf_names(params))
        leaves = [_get(params, n).requires_grad_() for n in names]
        f0, b0 = flash_attention_cuda.launches, flash_attention_bwd_cuda.launches
        loss = lm_loss(cfg, params, tok.to(device), lab.to(device),
                       loss_chunk=16)
        grads = torch.autograd.grad(loss, leaves)
        if device == cuda:
            assert flash_attention_cuda.launches - f0 == 2 * cfg.n_layers
            assert flash_attention_bwd_cuda.launches - b0 == \
                BWD_LAUNCHES_PER_CALL * cfg.n_layers
        out.append((loss.item(), [g.cpu() for g in grads], names))
    (lc, gc, names), (lg, gg, _) = out
    assert abs(lc - lg) <= 1e-5
    assert "layers/moe/router" in names
    for name, a, b in zip(names, gg, gc):
        assert b.norm() > 0, name
        torch.testing.assert_close(a, b, **TRAIN_TOL, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,d,N", [
    (1, 1, 1, 1),
    (2, 37, 5, 3),        # ragged S, N not a power of two
    (3, 70, 33, 8),       # d that no block of 16 channels divides
    (2, 9, 100, 16),
    (1, 130, 7, 1),       # one lane per channel
    (2, 20, 3, 32),       # a channel fills a warp
    (1, 17, 9, 5),
    (4, 512, 1024, 16),   # the model's prefill shape at a narrower d
])
def test_scan_kernel_matches_plain(cuda, dtype, B, S, d, N):
    rng = np.random.default_rng(S * 131 + d * 7 + N)
    decay = torch.sigmoid(_rand(rng, (B, S, d, N), torch.float32, cuda)) \
        .to(dtype)
    inc = (0.1 * _rand(rng, (B, S, d, N), torch.float32, cuda)).to(dtype)
    C = _rand(rng, (B, S, N), dtype, cuda)
    before = ssm_scan_cuda.launches
    got = ops.ssm_scan(decay, inc, C)
    torch.cuda.synchronize()
    assert ssm_scan_cuda.launches == before + 1
    want = ssm_scan_plain(decay, inc, C)
    assert got.dtype == torch.float32 and got.shape == (B, S, d)
    torch.testing.assert_close(got, want, **SCAN_TOL)


def test_scan_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 4, 3, 33, device=cuda)
    before = ssm_scan_cuda.launches
    with pytest.raises(ValueError, match="state size"):
        ssm_scan_cuda(x, x, torch.zeros(1, 4, 33, device=cuda))
    y = torch.zeros(1, 4, 3, 2, device=cuda)
    with pytest.raises(TypeError):
        ssm_scan_cuda(y, y, torch.zeros(1, 4, 2, device=cuda).half())
    assert ssm_scan_cuda.launches == before


@pytest.mark.parametrize("fused", [True, False])
def test_falcon_smoke_on_cuda_matches_cpu(cuda, fused, monkeypatch):
    """The forward launches the fused K2 kernel once a layer (``fused``,
    the default) or the unfused K2 kernel (``fused=False``); decode
    launches neither."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import forward, init_cache, init_lm, serve_step
    from repro_torch.models import ssm as SSM
    if not fused:
        monkeypatch.setattr(SSM, "ssm_block", lambda p, u, cfg, chunk=1024:
                            SSM.mamba1_block(p, u, d_state=cfg.ssm_state,
                                             chunk=chunk, fused=False))
    kernel = ss.ssm_scan_fused_cuda if fused else ssm_scan_cuda
    other = ssm_scan_cuda if fused else ss.ssm_scan_fused_cuda
    cfg = smoke(get_config("falcon-mamba-7b"))
    cpu = init_lm(cfg, 0, device="cpu")
    gpu = _to(cpu, cuda)
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    want = forward(cfg, cpu, tok)
    before, other_before = kernel.launches, other.launches
    got = forward(cfg, gpu, tok.to(cuda))
    assert kernel.launches - before == cfg.n_layers
    assert other.launches == other_before
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    c_cpu = init_cache(cfg, 2, 16, device="cpu")
    c_gpu = init_cache(cfg, 2, 16, device=cuda)
    before = kernel.launches
    for i in range(8):
        lc, c_cpu = serve_step(cfg, cpu, c_cpu, tok[:, i:i + 1])
        lg, c_gpu = serve_step(cfg, gpu, c_gpu, tok[:, i:i + 1].to(cuda))
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    assert kernel.launches == before   # decode reaches no kernel
    torch.testing.assert_close(c_gpu["ssm"]["h"].cpu(), c_cpu["ssm"]["h"],
                               rtol=1e-4, atol=1e-4)


def test_zamba2_smoke_on_cuda_matches_cpu(cuda):
    """The hybrid smoke model: a K1 prefill launch for each of its shared
    attention applications in the forward, a K1 decode launch for each in
    every decode step; logits and every cache against the CPU's."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import forward, init_cache, init_lm, serve_step
    cfg = smoke(get_config("zamba2-2.7b"))
    G = cfg.n_layers // cfg.shared_attn_every
    cpu = init_lm(cfg, 0, device="cpu")
    gpu = _to(cpu, cuda)
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    want = forward(cfg, cpu, tok)
    before = flash_attention_cuda.launches
    got = forward(cfg, gpu, tok.to(cuda))
    assert flash_attention_cuda.launches - before == G
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    c_cpu = init_cache(cfg, 2, 16, device="cpu")
    c_gpu = init_cache(cfg, 2, 16, device=cuda)
    before = flash_attention_cuda.launches
    for i in range(8):
        lc, c_cpu = serve_step(cfg, cpu, c_cpu, tok[:, i:i + 1])
        lg, c_gpu = serve_step(cfg, gpu, c_gpu, tok[:, i:i + 1].to(cuda))
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    assert flash_attention_cuda.launches - before == 8 * G
    for name in ("k", "v"):
        torch.testing.assert_close(c_gpu[name].cpu(), c_cpu[name],
                                   rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(c_gpu["ssm"]["h"].cpu(), c_cpu["ssm"]["h"],
                               rtol=1e-4, atol=1e-4)


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


def test_set_with_a_lost_shard_and_a_delta_of_cuda_tensors(cuda, tmp_path):
    """CUDA tensors saved as 4 shards + 2 parity restore bit-equal onto the
    card after a data shard is deleted (through the parity); a delta of
    them, with one row changed, stores only that row's chunk and restores
    through its chain."""
    import os
    from repro_torch.checkpoint import (read_manifest, read_sharded_manifest,
                                        restore, save, shard_file)
    rng = np.random.default_rng(24)
    tree = {f"w{i}": _rand(rng, (64, 1024), torch.bfloat16, cuda)
            for i in range(6)}
    tree["v"] = _rand(rng, (4096,), torch.float32, cuda)
    path = str(tmp_path / "set.scda")
    save(path, tree, step=3, shards=4, parity=2, record_hashes=True,
         chunk_bytes=1 << 14)
    os.remove(shard_file(path, 1, 4))
    got, step = restore(path, device=cuda)
    assert step == 3
    for k, t in tree.items():
        assert got[k].device.type == "cuda" and torch.equal(
            got[k].view(torch.uint8), t.view(torch.uint8)), k

    new = {k: t.clone() for k, t in tree.items()}
    new["w2"][40] += 1.0
    dpath = str(tmp_path / "flat.scda")
    save(str(tmp_path / "base.scda"), tree, step=3, record_hashes=True,
         chunk_bytes=1 << 14)
    doc = save(dpath, new, step=4, chunk_bytes=1 << 14,
               delta_base=(read_manifest(str(tmp_path / "base.scda")),
                           "base.scda"))
    stored = {s["name"]: s["present"] for s in doc["leaves"]}
    assert stored == {k: ([40 * 1024 * 2 // (1 << 14)] if k == "w2" else [])
                      for k in tree}
    got, step = restore(dpath, like=tree)
    assert step == 4
    for k, t in new.items():
        assert got[k].device.type == "cuda" and torch.equal(
            got[k].view(torch.uint8), t.view(torch.uint8)), k
    assert read_sharded_manifest(path)["parity"]["m"] == 2


def _dtensor_state(device):
    rng = np.random.default_rng(26)
    return {"w": _rand(rng, (64, 48), torch.bfloat16, device),
            "v": _rand(rng, (30,), torch.float32, device),
            "n": torch.tensor(5, dtype=torch.int32, device=device)}


def _as_dtensor(full, mesh, spec):
    """``full`` as a DTensor on ``mesh`` under ``spec``, each rank keeping
    its own block (no collective)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.distributed.sharding import placements
    pl = placements(mesh, spec)
    lshape, off = compute_local_shape_and_global_offset(
        tuple(full.shape), mesh, pl)
    local = full[tuple(slice(o, o + n) for o, n in zip(off, lshape))]
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=full.shape, stride=full.stride())


def _two_rank_dtensor_checkpoint(path):
    """Rank body (``spawn_ranks``, 2 gloo ranks on one card): save the
    state as DTensors of CUDA tensors on a (2, 1) mesh, then restore it
    onto a (1, 2) mesh with other placements; every restored local shard
    on the card and bit-equal to its slice of the state."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.checkpoint import restore, save
    from repro_torch.core.comm import TorchDistComm
    from repro_torch.distributed.sharding import P, target
    cuda = torch.device("cuda", torch.cuda.current_device())
    state = _dtensor_state(cuda)
    axes = ("data", "model")
    m21 = init_device_mesh("cuda", (2, 1), mesh_dim_names=axes)
    m12 = init_device_mesh("cuda", (1, 2), mesh_dim_names=axes)
    saved = {"w": P("data", "model"), "v": P("data"), "n": P()}
    save(path, {k: _as_dtensor(v, m21, saved[k]) for k, v in state.items()},
         comm=TorchDistComm(), step=7)
    restored = {"w": P(None, "model"), "v": P(), "n": P()}
    got, step = restore(path, like={k: target(m12, restored[k], v)
                                    for k, v in state.items()})
    out = {"step": step}
    for k, t in got.items():
        local = t.to_local()
        lshape, off = compute_local_shape_and_global_offset(
            t.shape, m12, t.placements)
        want = state[k][tuple(slice(o, o + n) for o, n in zip(off, lshape))]
        out[k] = (local.device.type == "cuda" and torch.equal(
            local.reshape(-1).view(torch.uint8),
            want.contiguous().reshape(-1).view(torch.uint8)))
    return out


def test_dtensor_checkpoint_of_cuda_tensors_on_two_ranks(cuda, tmp_path):
    """Two gloo ranks on one card write a DTensor state of CUDA tensors
    (each rank its own windows): the file is a single process's save of
    the same values, and it restores under another mesh, exact."""
    from repro_torch.checkpoint import save
    from repro_torch.distributed.ranks import spawn_ranks
    path = str(tmp_path / "ranks.scda")
    results = spawn_ranks(_two_rank_dtensor_checkpoint, 2, path,
                          device="cuda")
    single = str(tmp_path / "single.scda")
    save(single, _dtensor_state(cuda), step=7)
    with open(path, "rb") as a, open(single, "rb") as b:
        assert a.read() == b.read()
    for r in results:
        assert r == {"step": 7, "w": True, "v": True, "n": True}


# ------------------------------------------------------------ K1 backward --
#: The backward against autograd of the plain version in f32 on the same
#: inputs.  f32: only the order of the sums differs.  bf16: the kernels round
#: P and dS to bf16 for their products and the gradients to bf16, so each
#: gradient is held by its relative L2 error.
BWD_TOL_F32 = dict(rtol=1e-4, atol=1e-4)
BWD_REL_BF16 = 1e-2
#: The log-sum-exp in f32 from the same inputs: the sum order and exp2's
#: rounding differ.
LSE_TOL = dict(rtol=1e-4, atol=1e-4)

BWD_CASES = [  # B, H, Hkv, Sq, Skv, D, causal, window, q_offset
    (2, 4, 2, 16, 16, 16, True, None, 0),        # the smoke configs' shape
    (1, 8, 8, 70, 70, 64, True, None, 0),        # group 1, ragged tiles
    (1, 16, 2, 100, 100, 128, True, None, 0),    # group 8
    (1, 4, 2, 20, 100, 32, False, None, 0),      # non-causal, Sq != Skv
    (2, 4, 4, 130, 130, 64, True, 16, 0),        # sliding window
    (1, 4, 2, 200, 200, 128, True, 70, 0),       # window edge inside tiles
    (1, 4, 2, 100, 100, 64, False, 30, 0),       # non-causal window
    (2, 4, 2, 5, 40, 32, True, 8, 30),           # offset and window
    (1, 6, 2, 50, 50, 32, True, None, 0),        # group 3 does not divide 64
    (1, 40, 8, 140, 140, 128, True, None, 0),    # group 5 (llama4-scout)
    (1, 48, 8, 160, 160, 128, True, 50, 0),      # group 6 (nemotron-4), window
    (1, 8, 2, 129, 257, 128, False, None, 0),    # ragged position and key blocks
    (2, 16, 8, 129, 257, 128, True, None, 128),  # q_offset > 0 at D 128
    (1, 64, 1, 20, 20, 16, True, None, 0),       # group 64
    (1, 2, 1, 8, 8, 64, True, 0, 0),             # empty window: all zero
    (2, 16, 8, 300, 300, 128, True, None, 0),    # qwen3's heads, ragged
    (1, 16, 8, 1024, 1024, 128, True, None, 0),  # qwen3's training length
    (1, 32, 32, 300, 300, 80, True, None, 0),    # zamba2's heads, ragged
    (2, 4, 4, 130, 130, 80, True, 16, 0),        # head dim 80, window
    (1, 4, 2, 20, 100, 80, False, None, 0),      # head dim 80, Sq != Skv
    (2, 8, 8, 129, 257, 80, True, None, 128),    # head dim 80, q_offset
    (1, 32, 32, 1024, 1024, 80, True, None, 0),  # zamba2's training length
    (1, 8, 4, 300, 300, 256, True, None, 0),     # gemma3's heads, ragged
    (1, 8, 4, 200, 200, 256, True, 70, 0),       # head dim 256, window edge in a tile
    (1, 4, 2, 20, 100, 256, False, None, 0),     # head dim 256, Sq != Skv
    (2, 8, 4, 129, 257, 256, True, None, 128),   # head dim 256, q_offset
    (1, 8, 4, 4096, 4096, 256, True, 1024, 0),   # gemma3's training length, window
    (1, 24, 8, 140, 140, 64, True, None, 0),     # granite's heads, group 3
    (1, 16, 16, 448, 1500, 64, False, None, 0),  # whisper's cross-attention
    (1, 16, 16, 1500, 1500, 64, False, None, 0),  # whisper's encoder
    (1, 32, 8, 300, 300, 128, True, None, 0),    # llava's heads, group 4
]


def _bwd_inputs(rng, dtype, cuda, B, H, Hkv, Sq, Skv, D):
    return (_rand(rng, (B, Sq, H, D), dtype, cuda),
            _rand(rng, (B, Skv, Hkv, D), dtype, cuda),
            _rand(rng, (B, Skv, Hkv, D), dtype, cuda),
            _rand(rng, (B, Sq, H, D), dtype, cuda))


def _hold_grad(got, want, dtype, what):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **BWD_TOL_F32, msg=what)
        return
    assert got.dtype == dtype, what
    norm = want.norm().item()
    if norm == 0:
        assert not got.float().abs().max().item(), what
        return
    rel = ((got.float() - want).norm() / norm).item()
    assert rel <= BWD_REL_BF16, f"{what}: relative L2 {rel}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal,window,q_offset",
                         BWD_CASES)
def test_backward_matches_plain_autograd(cuda, dtype, B, H, Hkv, Sq, Skv, D,
                                         causal, window, q_offset):
    rng = np.random.default_rng(Sq * 7 + Skv + D)
    q, k, v, dout = _bwd_inputs(rng, dtype, cuda, B, H, Hkv, Sq, Skv, D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
    torch.testing.assert_close(lse, lse_plain(q, k, v, **kw), **LSE_TOL)
    before = flash_attention_bwd_cuda.launches
    got = flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd_cuda.launches == before + BWD_LAUNCHES_PER_CALL
    want = flash_attention_bwd_plain(q, k, v, dout, **kw)
    for name, g, w in zip("qkv", got, want):
        _hold_grad(g, w, dtype, f"d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D", [(16, 8, 128), (32, 32, 80), (8, 4, 256)])
def test_backward_is_deterministic(cuda, dtype, H, Hkv, D):
    """No atomics: two backward calls on the same inputs give the same bits."""
    rng = np.random.default_rng(11)
    q, k, v, dout = _bwd_inputs(rng, dtype, cuda, 2, H, Hkv, 300, 300, D)
    out, lse = flash_attention_cuda(q, k, v, with_lse=True)
    a = flash_attention_bwd_cuda(q, k, v, out, dout, lse)
    b = flash_attention_bwd_cuda(q, k, v, out, dout, lse)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_lse_output_leaves_the_forward_unchanged(cuda):
    rng = np.random.default_rng(12)
    q, k, v, _ = _bwd_inputs(rng, torch.bfloat16, cuda, 2, 16, 8, 130, 130,
                             128)
    plain = flash_attention_cuda(q, k, v)
    out, _ = flash_attention_cuda(q, k, v, with_lse=True)
    assert torch.equal(plain, out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 80, 256])
def test_autograd_goes_through_the_kernels(cuda, dtype, D):
    """ops.flash_attention under autograd: one forward launch, the backward
    kernels' launches, and the gradients of the plain version."""
    rng = np.random.default_rng(13)
    q, k, v, dout = _bwd_inputs(rng, dtype, cuda, 2, 8, 2, 70, 70, D)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = flash_attention_cuda.launches, flash_attention_bwd_cuda.launches
    out = ops.flash_attention(*leaves, window=40)
    out.backward(dout)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == f0 + 1
    assert flash_attention_bwd_cuda.launches == b0 + BWD_LAUNCHES_PER_CALL
    want = flash_attention_bwd_plain(q, k, v, dout, window=40)
    for name, leaf, w in zip("qkv", leaves, want):
        _hold_grad(leaf.grad, w, dtype, f"d{name}")


def test_no_kernel_drops_a_gradient(cuda):
    """Where no backward kernel exists the call raises: the decode kernel,
    a query offset held in a tensor, a direct launch of K1's forward with
    inputs that require grad, and the unfused K2.  The fused K2 under grad
    goes through its autograd Function (its output has a grad_fn); a
    direct launch of it with inputs that require grad raises."""
    rng = np.random.default_rng(14)
    q = _rand(rng, (1, 1, 4, 64), torch.float32, cuda).requires_grad_()
    k = _rand(rng, (1, 30, 2, 64), torch.float32, cuda)
    with pytest.raises(NotImplementedError, match="decode"):
        ops.flash_attention(q, k, k)
    q6 = _rand(rng, (1, 6, 4, 64), torch.float32, cuda).requires_grad_()
    off = torch.tensor(3, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="tensor"):
        ops.flash_attention(q6, k, k, q_offset=off)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash_attention_cuda(q6, k, k)
    with torch.no_grad():   # without grad mode the forward kernels serve
        assert flash_attention_cuda(q6, k, k).shape == q6.shape
    x = torch.rand(1, 4, 3, 2, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="requires grad"):
        ssm_scan_cuda(x, x, torch.zeros(1, 4, 2, device=cuda))
    with pytest.raises(NotImplementedError, match="requires grad"):
        ops.ssm_scan(x, x, torch.zeros(1, 4, 2, device=cuda))
    xs = torch.rand(1, 4, 3, device=cuda, requires_grad=True)
    bc = torch.rand(1, 4, 2, device=cuda)
    A = -torch.rand(3, 2, device=cuda)
    assert ops.mamba1_scan(xs, xs, bc, bc, A).grad_fn is not None
    with pytest.raises(NotImplementedError, match="requires grad"):
        ss.ssm_scan_fused_cuda(xs, xs, bc, bc, A)
    with torch.no_grad():
        assert ops.mamba1_scan(xs, xs, bc, bc, A).grad_fn is None


# ------------------------------------------------------- the training path --
#: The smoke model (f32) on CUDA against the CPU: K1's kernels against the
#: plain attention, cuBLAS against the CPU's matmuls; only sum orders differ.
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)


def _smoke_batch(cfg, B=2, S=32, seed=5):
    seq = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    return (torch.from_numpy(seq[:, :-1].astype(np.int32)),
            torch.from_numpy(seq[:, 1:].astype(np.int64)))


def test_smoke_loss_and_gradients_on_cuda_match_cpu(cuda):
    """lm_loss and every leaf's gradient through K1's forward and backward
    on the card against the same on the CPU."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import init_lm, lm_loss
    cfg = smoke(get_config("qwen3-1.7b"))
    tok, lab = _smoke_batch(cfg)
    out = []
    for device in ("cpu", cuda):
        params = _to(init_lm(cfg, 0, device="cpu"), device)
        names = sorted(_leaf_names(params))
        leaves = [_get(params, n).requires_grad_() for n in names]
        f0, b0 = flash_attention_cuda.launches, flash_attention_bwd_cuda.launches
        loss = lm_loss(cfg, params, tok.to(device), lab.to(device),
                       loss_chunk=16)
        grads = torch.autograd.grad(loss, leaves)
        if device == cuda:
            assert flash_attention_cuda.launches - f0 == 2 * cfg.n_layers
            assert flash_attention_bwd_cuda.launches - b0 == \
                BWD_LAUNCHES_PER_CALL * cfg.n_layers
        out.append((loss.item(), [g.cpu() for g in grads], names))
    (lc, gc, names), (lg, gg, _) = out
    assert abs(lc - lg) <= 1e-5
    for name, a, b in zip(names, gg, gc):
        assert b.norm() > 0, name
        torch.testing.assert_close(a, b, **TRAIN_TOL, msg=name)


#: The hybrid smoke model's f32 gradients, two evaluations in another sum
#: order, by relative L2: its Mamba2 layers' gradients (A_log's, the tied
#: embedding's) move by up to 1.2e-4 between two f32 evaluations
#: (tests/test_torch_hybrid.py's GRAD_REL).
HYBRID_GRAD_REL = 2e-4


def test_hybrid_smoke_loss_and_gradients_on_cuda_match_cpu(cuda):
    """The zamba2 smoke model at head dim 80 (zamba2's): lm_loss and every
    leaf's gradient through K1's forward and its backward at D 80, one of
    each a shared-attention application (the forward twice: remat), and
    the Mamba2 layers through autograd of plain torch, against the same
    on the CPU: the loss within 1e-5, each gradient within HYBRID_GRAD_REL
    by relative L2."""
    import dataclasses
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import init_lm, lm_loss
    cfg = dataclasses.replace(smoke(get_config("zamba2-2.7b")), head_dim=80)
    G = cfg.n_layers // cfg.shared_attn_every
    tok, lab = _smoke_batch(cfg)
    out = []
    for device in ("cpu", cuda):
        params = _to(init_lm(cfg, 0, device="cpu"), device)
        names = sorted(_leaf_names(params))
        leaves = [_get(params, n).requires_grad_() for n in names]
        f0, b0 = flash_attention_cuda.launches, flash_attention_bwd_cuda.launches
        loss = lm_loss(cfg, params, tok.to(device), lab.to(device),
                       loss_chunk=16)
        grads = torch.autograd.grad(loss, leaves)
        if device == cuda:
            assert flash_attention_cuda.launches - f0 == 2 * G
            assert flash_attention_bwd_cuda.launches - b0 == \
                BWD_LAUNCHES_PER_CALL * G
        out.append((loss.item(), [g.cpu() for g in grads], names))
    (lc, gc, names), (lg, gg, _) = out
    assert abs(lc - lg) <= 1e-5
    assert "shared_attn/attn/wq" in names
    for name, a, b in zip(names, gg, gc):
        assert b.norm() > 0, name
        rel = ((a - b).norm() / b.norm()).item()
        assert rel <= HYBRID_GRAD_REL, f"{name}: relative L2 {rel}"


def test_gemma_smoke_loss_and_gradients_at_head_dim_256_on_cuda_match_cpu(
        cuda):
    """gemma3's smoke config at its head dim 256 with its 5:1 pattern (a
    window of 8 keys on layers 0-4, layer 5 global) over 32 tokens:
    lm_loss and every leaf's gradient through K1's forward (twice a layer:
    remat) and its backward at D 256, each layer with its window, against
    the same on the CPU."""
    import dataclasses
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import init_lm, lm_loss
    cfg = dataclasses.replace(smoke(get_config("gemma3-4b")), head_dim=256,
                              attn_window=8, local_global_pattern=5,
                              n_layers=6)
    tok, lab = _smoke_batch(cfg)
    out = []
    for device in ("cpu", cuda):
        params = _to(init_lm(cfg, 0, device="cpu"), device)
        names = sorted(_leaf_names(params))
        leaves = [_get(params, n).requires_grad_() for n in names]
        f0, b0 = flash_attention_cuda.launches, flash_attention_bwd_cuda.launches
        loss = lm_loss(cfg, params, tok.to(device), lab.to(device),
                       loss_chunk=16)
        grads = torch.autograd.grad(loss, leaves)
        if device == cuda:
            assert flash_attention_cuda.launches - f0 == 2 * cfg.n_layers
            assert flash_attention_bwd_cuda.launches - b0 == \
                BWD_LAUNCHES_PER_CALL * cfg.n_layers
        out.append((loss.item(), [g.cpu() for g in grads], names))
    (lc, gc, names), (lg, gg, _) = out
    assert abs(lc - lg) <= 1e-5
    for name, a, b in zip(names, gg, gc):
        assert b.norm() > 0, name
        torch.testing.assert_close(a, b, **TRAIN_TOL, msg=name)


def _whisper_smoke():
    """whisper's smoke config at its own heads shrunk (2 / 2 heads of 64,
    group 1) over 23 source frames: the last key tile ragged in the
    encoder and in the cross-attention."""
    import dataclasses
    from repro_torch.configs import get_config, smoke
    return dataclasses.replace(smoke(get_config("whisper-medium")),
                               n_heads=2, n_kv_heads=2, head_dim=64,
                               max_source_len=23)


def _llava_smoke():
    """llava's smoke config at its head dim and group (4 / 1 heads of
    128, group 4), with its 8 patch embeddings."""
    import dataclasses
    from repro_torch.configs import get_config, smoke
    return dataclasses.replace(smoke(get_config("llava-next-mistral-7b")),
                               n_heads=4, n_kv_heads=1, head_dim=128)


def _embeds(cfg, B=2, seed=7):
    """The family's other input from a numpy seed (CPU tensors)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        shape, key = (B, cfg.max_source_len, cfg.d_model), "enc_embeds"
    else:
        shape, key = (B, cfg.num_patches, cfg.d_model), "patch_embeds"
    return {key: torch.from_numpy(rng.standard_normal(shape)
                                  .astype(np.float32))}


@pytest.mark.parametrize("make", [_whisper_smoke, _llava_smoke])
def test_encdec_and_vlm_smoke_on_cuda_match_cpu(cuda, make):
    """The whisper and llava smoke models on the card against the CPU in
    f32: the forward (whisper: K1 in each encoder layer and twice in each
    decoder layer, self- and cross-attention; llava: once a layer over the
    image and the text) and 8 decode steps (whisper's decode kernel twice
    a layer, the cross-attention's against the cached encoder output;
    llava's once a layer), every launch counted."""
    from repro_torch.models import (encode, forward, init_cache, init_lm,
                                    serve_step)
    cfg = make()
    encdec = cfg.family == "encdec"
    cpu = init_lm(cfg, 0, device="cpu")
    gpu = _to(cpu, cuda)
    tok = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    kw = _embeds(cfg)
    want = forward(cfg, cpu, tok, **kw)
    before = flash_attention_cuda.launches
    got = forward(cfg, gpu, tok.to(cuda),
                  **{k: v.to(cuda) for k, v in kw.items()})
    per_forward = (cfg.encoder_layers + 2 * cfg.n_layers if encdec
                   else cfg.n_layers)
    assert flash_attention_cuda.launches - before == per_forward
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    c_cpu = init_cache(cfg, 2, 16, device="cpu")
    c_gpu = init_cache(cfg, 2, 16, device=cuda)
    if encdec:
        before = flash_attention_cuda.launches
        enc = encode(cfg, gpu, kw["enc_embeds"].to(cuda))
        assert flash_attention_cuda.launches - before == cfg.encoder_layers
        c_gpu["enc_out"].copy_(enc)
        c_cpu["enc_out"].copy_(encode(cfg, cpu, kw["enc_embeds"]))
    for i in range(8):
        before = flash_attention_cuda.launches
        lc, c_cpu = serve_step(cfg, cpu, c_cpu, tok[:, i:i + 1])
        lg, c_gpu = serve_step(cfg, gpu, c_gpu, tok[:, i:i + 1].to(cuda))
        assert flash_attention_cuda.launches - before == \
            (2 if encdec else 1) * cfg.n_layers
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("make", [_whisper_smoke, _llava_smoke])
def test_encdec_and_vlm_smoke_loss_and_gradients_on_cuda_match_cpu(cuda,
                                                                   make):
    """lm_loss and every leaf's gradient of the whisper and llava smoke
    models through K1's forward (twice a call: remat) and its backward
    (whisper's without the causal mask in the encoder and the
    cross-attention, 32 positions against 23 frames; llava's over the
    image and the text), against the same on the CPU."""
    from repro_torch.models import init_lm, lm_loss
    cfg = make()
    calls = (cfg.encoder_layers + 2 * cfg.n_layers
             if cfg.family == "encdec" else cfg.n_layers)
    tok, lab = _smoke_batch(cfg)
    kw = _embeds(cfg)
    out = []
    for device in ("cpu", cuda):
        params = _to(init_lm(cfg, 0, device="cpu"), device)
        names = sorted(_leaf_names(params))
        leaves = [_get(params, n).requires_grad_() for n in names]
        f0, b0 = flash_attention_cuda.launches, flash_attention_bwd_cuda.launches
        loss = lm_loss(cfg, params, tok.to(device), lab.to(device),
                       loss_chunk=16,
                       **{k: v.to(device) for k, v in kw.items()})
        grads = torch.autograd.grad(loss, leaves)
        if device == cuda:
            assert flash_attention_cuda.launches - f0 == 2 * calls
            assert flash_attention_bwd_cuda.launches - b0 == \
                BWD_LAUNCHES_PER_CALL * calls
        out.append((loss.item(), [g.cpu() for g in grads], names))
    (lc, gc, names), (lg, gg, _) = out
    assert abs(lc - lg) <= 1e-5
    assert ("layers/cross/wk" if cfg.family == "encdec" else "mm_proj") \
        in names
    for name, a, b in zip(names, gg, gc):
        assert b.norm() > 0, name
        torch.testing.assert_close(a, b, **TRAIN_TOL, msg=name)


def _leaf_names(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_names(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}"


def _get(tree, name):
    for part in name.split("/"):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "falcon-mamba-7b",
                                  "zamba2-2.7b", "gemma3-4b",
                                  "granite-moe-3b-a800m"])
def test_kill_and_resume_on_cuda_matches_an_uninterrupted_run(cuda,
                                                               tmp_path,
                                                               arch):
    """tests/test_system.py::TestTrainLoop's restart, on the card."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainLoopConfig, train
    cfg = smoke(get_config(arch))

    def run(path, hooks=None):
        loop = TrainLoopConfig(total_steps=12, ckpt_every=4,
                               ckpt_dir=str(path), log_every=100)
        return train(cfg, loop, AdamWConfig(total_steps=12), seq_len=32,
                     global_batch=4, hooks=hooks)

    with pytest.raises(SystemExit):
        run(tmp_path / "c", {"should_die": lambda s: s == 6})
    out = run(tmp_path / "c")
    assert out["start_step"] == 4
    assert out["state"]["params"]["embed"].device.type == "cuda"
    ref = run(tmp_path / "ref")
    assert abs(out["losses"][-1] - ref["losses"][-1]) < 0.05
    for o in (out, ref):
        o["manager"].close()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "falcon-mamba-7b",
                                  "zamba2-2.7b", "gemma3-4b",
                                  "granite-moe-3b-a800m"])
def test_launcher_trains_on_the_card(cuda, tmp_path, capsys, arch):
    """python -m repro_torch.launch.train --arch <arch>: the card is the
    default device; falcon-mamba's steps go through the fused K2 and its
    backward, qwen3's, zamba2's, gemma3's and granite's through K1's
    backward."""
    from repro_torch.launch import train as launch
    f0, b0 = ss.ssm_scan_fused_cuda.launches, ss.ssm_scan_bwd_cuda.launches
    a0 = flash_attention_bwd_cuda.launches
    launch.main(["--arch", arch, "--steps", "3", "--seq-len", "16",
                 "--global-batch", "2", "--ckpt-every", "2", "--ckpt-dir",
                 str(tmp_path)])
    out = capsys.readouterr().out
    assert "done: start_step=-1" in out and "checkpoints=[2]" in out
    trained = (ss.ssm_scan_fused_cuda.launches > f0,
               ss.ssm_scan_bwd_cuda.launches > b0)
    assert trained == ((True, True) if arch == "falcon-mamba-7b"
                       else (False, False))
    assert (flash_attention_bwd_cuda.launches > a0) == (
        arch != "falcon-mamba-7b")


def test_pinned_snapshot_is_not_reached_by_in_place_updates(cuda,
                                                            tmp_path):
    """save() returns once CUDA leaves are copied into pinned host
    buffers; an in-place update right after does not reach the file, and a
    second save reuses the buffers."""
    from repro_torch.checkpoint.manager import CheckpointManager
    rng = np.random.default_rng(21)
    tree = {"w": _rand(rng, (256, 1024), torch.float32, cuda),
            "h": _rand(rng, (64, 32), torch.bfloat16, cuda)}
    want = {k: v.clone() for k, v in tree.items()}
    with CheckpointManager(str(tmp_path / "c")) as mgr:
        mgr.save(1, tree)
        for v in tree.values():
            v.add_(1)
        mgr.wait()
        pinned = dict(mgr._pinned)
        assert all(b.is_pinned() for b in pinned.values())
        mgr.save(2, tree, blocking=True)
        assert all(mgr._pinned[k] is b for k, b in pinned.items())
        got, _ = mgr.restore(1, device=cuda)
        again, _ = mgr.restore(2, device=cuda)
    for k in tree:
        assert torch.equal(got[k], want[k]) and torch.equal(again[k], tree[k])


# ------------------------------------------- the fused K2 and its backward --
#: The fused forward against mamba1_scan_plain: the same rounded products,
#: an accurate f32 exp on both sides, the state rounded identically; only
#: y's sum over n differs (SCAN_TOL).  The backward against autograd of the
#: plain version on f32 copies of the inputs: f32 gradients within
#: SCAN_BWD_REL_MAX of their largest element (sums over channels and steps
#: in another order), bf16 ones by relative L2 (rounded once), dA (f32)
#: as in f32.
SCAN_BWD_REL_MAX = 1e-4
SCAN_BWD_REL_BF16 = 1e-2

FUSED_CASES = [  # B, S, d, N, B and C: contiguous (False), rows of 5 + 2N
    # from offset 5 (True: never TMA-aligned), rows of 16 + 2N from offset
    # 16 ("aligned": TMA-aligned where d and N allow)
    (1, 1, 1, 1, False),
    (2, 37, 5, 3, False),     # ragged S, N not a power of two
    (3, 70, 33, 8, True),     # d that no block divides, strided
    (1, 130, 7, 1, False),    # one lane per channel
    (2, 20, 3, 32, True),     # 32 states
    (2, 9, 100, 16, False),   # the model's N, S within a stage
    (2, 33, 24, 2, "aligned"),     # 2 states (a B row too short for TMA)
    (1, 64, 300, 16, True),   # S a multiple of 16, several blocks
    (2, 41, 24, 16, True),
    (1, 200, 700, 16, True),  # S no multiple of a stage
    (2, 45, 64, 16, "aligned"),    # S past a stage, no multiple of 16
    (3, 70, 40, 8, "aligned"),     # d that no block divides
    (1, 20, 96, 32, "aligned"),    # 32 states, S within a stage
    (16, 5, 4096, 16, False),      # the backward walks passes: TMA
    (16, 5, 4096, 16, True),       # ... and on the threads' load path
]


def _lanes(N, bwd):
    """The lanes a channel the plan gives at state size N: one in the
    forward, by the power of two at least N in the backward (each of the
    backward's instantiations is reached by an N of FUSED_CASES)."""
    return ss.BWD_LANES[1 << max(0, N - 1).bit_length()] if bwd else 1


def _fused_inputs(rng, dtype, cuda, B, S, d, N, strided):
    x = _rand(rng, (B, S, d), dtype, cuda)
    dt = torch.nn.functional.softplus(
        _rand(rng, (B, S, d), torch.float32, cuda) - 1).to(dtype)
    if strided:
        lead = 16 if strided == "aligned" else 5
        dbc = _rand(rng, (B, S, lead + 2 * N), dtype, cuda)
        Bs, Cs = dbc[..., lead:lead + N], dbc[..., lead + N:]
    else:
        Bs, Cs = (_rand(rng, (B, S, N), dtype, cuda) for _ in range(2))
    A = -torch.exp(torch.log(torch.arange(1, N + 1, device=cuda,
                                          dtype=torch.float32))
                   + 0.3 * _rand(rng, (d, N), torch.float32, cuda))
    return x, dt, Bs, Cs, A.contiguous()


def _tma_path(dtype, d, N, strided):
    """The load path the case's layout allows: TMA needs 16-byte aligned
    rows and a B row of P elements a multiple of 16 bytes."""
    es = 4 if dtype == torch.float32 else 2
    P = 1 << max(0, N - 1).bit_length()
    lead, row = {False: (0, N), True: (5, 5 + 2 * N),
                 "aligned": (16, 16 + 2 * N)}[strided]
    return all(v * es % 16 == 0 for v in (d, lead, row, P))


def _hold_scan_grad(got, want, what):
    if got.dtype == torch.bfloat16:
        err = (got.float() - want).norm().item()
        assert err <= SCAN_BWD_REL_BF16 * want.norm().item(), \
            f"{what}: L2 error {err}, norm {want.norm().item()}"
        return
    assert got.dtype == want.dtype, what
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= SCAN_BWD_REL_MAX * scale, f"{what}: {err}, largest {scale}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,d,N,strided", FUSED_CASES)
def test_fused_scan_matches_plain(cuda, dtype, B, S, d, N, strided):
    rng = np.random.default_rng(S * 31 + d + N)
    x, dt, Bs, Cs, A = _fused_inputs(rng, dtype, cuda, B, S, d, N, strided)
    states = torch.full(ss.states_shape(B, S, d, N), float("nan"),
                        device=cuda)
    before = ss.ssm_scan_fused_cuda.launches
    got = ss.ssm_scan_fused_cuda(x, dt, Bs, Cs, A, states=states)
    torch.cuda.synchronize()
    assert ss.ssm_scan_fused_cuda.launches == before + 1
    plan = ss.ssm_scan_fused_cuda.last_plan
    assert plan.lanes == _lanes(N, bwd=False)
    assert plan.tma == _tma_path(dtype, d, N, strided)
    assert got.dtype == torch.float32 and got.shape == (B, S, d)
    torch.testing.assert_close(got, ss.mamba1_scan_plain(x, dt, Bs, Cs, A),
                               **SCAN_TOL)
    torch.testing.assert_close(states, ss.scan_states_plain(x, dt, Bs, A),
                               **SCAN_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,d,N,strided", FUSED_CASES)
def test_scan_bwd_matches_plain_autograd(cuda, dtype, B, S, d, N, strided):
    rng = np.random.default_rng(S * 37 + d + N)
    x, dt, Bs, Cs, A = _fused_inputs(rng, dtype, cuda, B, S, d, N, strided)
    dy = _rand(rng, (B, S, d), torch.float32, cuda)
    states = torch.empty(ss.states_shape(B, S, d, N), device=cuda)
    ss.ssm_scan_fused_cuda(x, dt, Bs, Cs, A, states=states)
    before = ss.ssm_scan_bwd_cuda.launches
    got = ss.ssm_scan_bwd_cuda(x, dt, Bs, Cs, A, dy, states)
    torch.cuda.synchronize()
    assert ss.ssm_scan_bwd_cuda.launches == \
        before + ss.BWD_LAUNCHES_PER_CALL
    plan = ss.ssm_scan_bwd_cuda.last_plan
    assert plan.lanes == _lanes(N, bwd=True)
    assert plan.tma == _tma_path(dtype, d, N, strided)
    leaves = [t.float().requires_grad_() for t in (x, dt, Bs, Cs, A)]
    want = torch.autograd.grad(ss.mamba1_scan_plain(*leaves), leaves, dy)
    for name, g, w, t in zip(("x", "dt", "B", "C", "A"), got, want,
                             (x, dt, Bs, Cs, A)):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        _hold_scan_grad(g, w, f"d{name}")


@pytest.mark.parametrize("B,S,d,N,strided", FUSED_CASES)
def test_scan_bwd_bf16_rounds_the_f32_sums_once(cuda, B, S, d, N, strided):
    """bf16 dx and ddt are the f32 instantiation's, on the same values,
    rounded to bf16 once (what ``.to(torch.bfloat16)`` does), both under
    the same lanes a channel."""
    rng = np.random.default_rng(S * 41 + d + N)
    x, dt, Bs, Cs, A = _fused_inputs(rng, torch.bfloat16, cuda, B, S, d, N,
                                     strided)
    dy = _rand(rng, (B, S, d), torch.float32, cuda)
    states = torch.empty(ss.states_shape(B, S, d, N), device=cuda)
    ss.ssm_scan_fused_cuda(x, dt, Bs, Cs, A, states=states)
    got = ss.ssm_scan_bwd_cuda(x, dt, Bs, Cs, A, dy, states)
    lanes = ss.ssm_scan_bwd_cuda.last_plan.lanes
    f32 = ss.ssm_scan_bwd_cuda(*(t.float() for t in (x, dt, Bs, Cs)), A, dy,
                               states)
    torch.cuda.synchronize()
    assert ss.ssm_scan_bwd_cuda.last_plan.lanes == lanes
    for name, g, w in zip(("dx", "ddt"), got[:2], f32[:2]):
        assert g.dtype == torch.bfloat16 and w.dtype == torch.float32
        assert torch.equal(g, w.to(torch.bfloat16)), name


@pytest.mark.parametrize("strided", [True, "aligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_bwd_is_deterministic(cuda, dtype, strided):
    """No float atomics: two backward calls give the same bits, on either
    load path."""
    rng = np.random.default_rng(17)
    x, dt, Bs, Cs, A = _fused_inputs(rng, dtype, cuda, 4, 300, 2048, 16,
                                     strided)
    dy = _rand(rng, (4, 300, 2048), torch.float32, cuda)
    states = torch.empty(ss.states_shape(4, 300, 2048, 16), device=cuda)
    ss.ssm_scan_fused_cuda(x, dt, Bs, Cs, A, states=states)
    a = ss.ssm_scan_bwd_cuda(x, dt, Bs, Cs, A, dy, states)
    assert ss.ssm_scan_bwd_cuda.last_plan.tma == (strided == "aligned")
    b = ss.ssm_scan_bwd_cuda(x, dt, Bs, Cs, A, dy, states)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_fused_scan_writes_states_only_under_grad(cuda, monkeypatch):
    """ops.mamba1_scan: without grad the fused kernel gets no states buffer
    (serving writes y alone); with grad its Function passes one, and the
    backward wrapper is called once."""
    rng = np.random.default_rng(18)
    x, dt, Bs, Cs, A = _fused_inputs(rng, torch.float32, cuda, 2, 40, 24,
                                     16, True)
    seen = []
    real = ss.SsmScanFusedKernel.__call__

    def spy(self, *args, states=None):
        seen.append(states)
        return real(self, *args, states=states)

    monkeypatch.setattr(ss.SsmScanFusedKernel, "__call__", spy)
    with torch.no_grad():
        y0 = ops.mamba1_scan(x, dt, Bs, Cs, A)
    leaves = [t.clone().requires_grad_() for t in (x, dt, Bs, Cs, A)]
    b0 = ss.ssm_scan_bwd_cuda.launches
    y1 = ops.mamba1_scan(*leaves)
    y1.sum().backward()
    torch.cuda.synchronize()
    assert seen[0] is None and seen[1] is not None
    assert tuple(seen[1].shape) == ss.states_shape(2, 40, 24, 16)
    assert ss.ssm_scan_bwd_cuda.launches == b0 + ss.BWD_LAUNCHES_PER_CALL
    assert torch.equal(y0, y1.detach())
    assert all(t.grad is not None for t in leaves)


def test_fused_kernels_refuse_what_they_do_not_take(cuda):
    rng = np.random.default_rng(19)
    x, dt, Bs, Cs, A = _fused_inputs(rng, torch.float32, cuda, 1, 8, 4, 2,
                                     False)
    before = ss.ssm_scan_fused_cuda.launches
    with pytest.raises(TypeError):
        ss.ssm_scan_fused_cuda(x.half(), dt.half(), Bs.half(), Cs.half(), A)
    with pytest.raises(ValueError, match="state size"):
        ss.ssm_scan_fused_cuda(x, dt, *(torch.zeros(1, 8, 33, device=cuda),) * 2,
                               torch.zeros(4, 33, device=cuda))
    with pytest.raises(ValueError, match="states"):
        ss.ssm_scan_fused_cuda(x, dt, Bs, Cs, A,
                               states=torch.empty(1, 3, 4, 2, device=cuda))
    assert ss.ssm_scan_fused_cuda.launches == before


def test_falcon_smoke_loss_and_gradients_on_cuda_match_cpu(cuda):
    """lm_loss and every leaf's gradient of the falcon-mamba smoke model
    through the fused K2 forward (twice a layer: the forward and the remat
    recompute) and its backward (once a layer) against the same on the
    CPU; neither K1 nor the unfused K2 runs."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import init_lm, lm_loss
    cfg = smoke(get_config("falcon-mamba-7b"))
    tok, lab = _smoke_batch(cfg)
    out = []
    for device in ("cpu", cuda):
        params = _to(init_lm(cfg, 0, device="cpu"), device)
        names = sorted(_leaf_names(params))
        leaves = [_get(params, n).requires_grad_() for n in names]
        counts = [k.launches for k in (ss.ssm_scan_fused_cuda,
                                       ss.ssm_scan_bwd_cuda, ssm_scan_cuda,
                                       flash_attention_cuda)]
        loss = lm_loss(cfg, params, tok.to(device), lab.to(device),
                       loss_chunk=16)
        grads = torch.autograd.grad(loss, leaves)
        if device == cuda:
            got = [k.launches - c for k, c in zip(
                (ss.ssm_scan_fused_cuda, ss.ssm_scan_bwd_cuda, ssm_scan_cuda,
                 flash_attention_cuda), counts)]
            assert got == [2 * cfg.n_layers,
                           ss.BWD_LAUNCHES_PER_CALL * cfg.n_layers, 0, 0]
        out.append((loss.item(), [g.cpu() for g in grads], names))
    (lc, gc, names), (lg, gg, _) = out
    assert abs(lc - lg) <= 1e-5
    for name, a, b in zip(names, gg, gc):
        assert b.norm() > 0, name
        torch.testing.assert_close(a, b, **TRAIN_TOL, msg=name)


# ----------------------------------- decode with its log-sum-exp (SP decode) --
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 80, 128, 256])
@pytest.mark.parametrize("pos", [-7, 0, 150, 299, 520])
@pytest.mark.parametrize("window", [None, 64])
def test_decode_kernel_writes_the_log_sum_exp(cuda, dtype, D, pos, window):
    """The decode kernel asked for its log-sum-exp: lse_plain's values
    where a key is live, -inf where none is (a query offset below 0, as
    on a sequence shard past the position, or a window past the keys),
    the output unchanged, and in f32 with ``out_f32`` the output before
    its rounding."""
    rng = np.random.default_rng(D + pos + (window or 0))
    q = _rand(rng, (2, 1, 8, D), dtype, cuda)
    k = _rand(rng, (2, 300, 4, D), dtype, cuda)
    v = _rand(rng, (2, 300, 4, D), dtype, cuda)
    kw = dict(window=window,
              q_offset=torch.tensor(pos, dtype=torch.int32, device=cuda))
    out, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
    want = lse_plain(q, k, v, **kw)
    assert lse.shape == (2, 8, 1) and lse.dtype == torch.float32
    live = torch.isfinite(want)
    assert torch.equal(live, torch.isfinite(lse))
    torch.testing.assert_close(lse[live], want[live], **LSE_TOL)
    assert torch.equal(out, flash_attention_cuda(q, k, v, **kw))
    torch.testing.assert_close(out, flash_attention_plain(q, k, v, **kw),
                               **TOL[dtype])
    out32, lse32 = flash_attention_cuda(q, k, v, with_lse=True, out_f32=True,
                                        **kw)
    assert out32.dtype == torch.float32 and torch.equal(
        lse32.nan_to_num(), lse.nan_to_num())
    assert torch.equal(out32.to(dtype), out)
    if not bool(live.any()):
        assert not bool(out.any()) and not bool(out32.any())


def _tp_prefill_rank(tokens):
    """qwen3's smoke model in bf16 on a (1, 2) mesh of the ranks sharing
    the card: its weights as DTensors under the placement rules, the
    prefill's last logits (K1 on each rank's local heads) and its K1
    launches."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_lm
    from repro_torch.checkpoint.pytree_io import flatten_named
    from repro_torch.train.step import make_prefill_step
    cfg = dataclasses.replace(smoke(get_config("qwen3-1.7b")),
                              dtype="bfloat16")
    mesh = make_host_mesh(1, 2)
    sh.set_mesh(mesh)
    params = init_lm(cfg, 0, device="cuda", dtype=torch.bfloat16)
    named, rebuild = flatten_named(params)
    params = rebuild([sh.distribute(t, mesh, sh.leaf_spec(mesh, n, t))
                      for n, t in named])
    k1 = flash_attention_cuda
    k1.launches = 0
    with torch.no_grad():
        logits = make_prefill_step(cfg)(params, {"tokens": tokens.cuda()})
        logits = logits.full_tensor().float().cpu()
    sh.set_mesh(None)
    return logits, k1.launches


def test_tensor_parallel_prefill_on_two_ranks_of_one_card(cuda):
    """A (1, 2) mesh over two gloo ranks sharing the card: each runs K1 on
    its 2 of qwen3's smoke model's 4 heads (one kv head a rank), once a
    layer; the last logits are the single-device prefill's."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.distributed.ranks import spawn_ranks
    from repro_torch.models import init_lm
    from repro_torch.train.step import make_prefill_step
    cfg = dataclasses.replace(smoke(get_config("qwen3-1.7b")),
                              dtype="bfloat16")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    results = spawn_ranks(_tp_prefill_rank, 2, tokens, device="cuda")
    params = init_lm(cfg, 0, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad():
        want = make_prefill_step(cfg)(params, {"tokens": tokens.to(cuda)})
    for logits, launches in results:
        assert launches == cfg.n_layers
        torch.testing.assert_close(logits, want.float().cpu(),
                                   **TOL[torch.bfloat16])


def _train_grads_rank(tokens, labels, chunk):
    """qwen3's smoke model in f32 on a (2, 1) and a (1, 2) mesh of the two
    gloo ranks sharing the card: the train step's loss and gradients
    (``lm_loss`` with its remat'd layers, differentiated inside the mesh
    region as ``make_train_step`` does, the backward on autograd's device
    thread), every gradient made whole, and the K1 backward's launches."""
    from repro_torch.checkpoint.pytree_io import flatten_named
    from repro_torch.configs import get_config, smoke
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_lm, lm
    cfg = smoke(get_config("qwen3-1.7b"))
    out = {}
    for shape in ((2, 1), (1, 2)):
        mesh = make_host_mesh(*shape)
        sh.set_mesh(mesh)
        named, rebuild = flatten_named(init_lm(cfg, 0, device="cuda"))
        leaves = [sh.distribute(t, mesh, sh.leaf_spec(mesh, n, t))
                  .requires_grad_(True) for n, t in named]
        spec = sh.batch_spec(mesh, 2)
        tok = sh.distribute(tokens.cuda(), mesh, spec)
        lab = sh.distribute(labels.cuda(), mesh, spec)
        flash_attention_bwd_cuda.launches = 0
        with sh.mesh_region():
            loss = lm.lm_loss(cfg, rebuild(leaves), tok, lab,
                              loss_chunk=chunk)
            grads = torch.autograd.grad(loss, leaves)
        out[shape] = (float(loss.full_tensor()),
                      {n: g.full_tensor().cpu()
                       for (n, _), g in zip(named, grads)},
                      flash_attention_bwd_cuda.launches)
        sh.set_mesh(None)
    return out


def test_train_step_gradients_on_two_ranks_of_one_card(cuda):
    """The train step's loss and every gradient of qwen3's smoke model on
    two gloo ranks sharing the card, over data (FSDP: the gradients
    reduce-scattered) and over model (TP: K1 and its backward on each
    rank's local heads), against the single device's, in f32; each rank
    launches the K1 backward as often as the single device."""
    from repro_torch.checkpoint.pytree_io import flatten_named
    from repro_torch.configs import get_config, smoke
    from repro_torch.distributed.ranks import spawn_ranks
    from repro_torch.models import init_lm, lm
    cfg = smoke(get_config("qwen3-1.7b"))
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32))
                              .astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32)))
    results = spawn_ranks(_train_grads_rank, 2, tokens, labels, 16,
                          device="cuda")
    named, rebuild = flatten_named(init_lm(cfg, 0, device=cuda))
    leaves = [t.requires_grad_(True) for _, t in named]
    flash_attention_bwd_cuda.launches = 0
    loss = lm.lm_loss(cfg, rebuild(leaves), tokens.to(cuda),
                      labels.to(cuda), loss_chunk=16)
    grads = torch.autograd.grad(loss, leaves)
    launches = flash_attention_bwd_cuda.launches
    assert launches > 0
    for res in results:
        for shape, (got_loss, got_grads, got_launches) in res.items():
            assert got_launches == launches, shape
            torch.testing.assert_close(got_loss, float(loss),
                                       **TOL[torch.float32])
            for (name, _), g in zip(named, grads):
                torch.testing.assert_close(
                    got_grads[name], g.cpu(), **TOL[torch.float32],
                    msg=lambda m, name=name, shape=shape:
                    f"{name} on {shape}: {m}")


# -- the dry-run's fake allocations against the card's allocator ---------

def _k1_case(dev, B, Sq, Skv, H, Hkv, D):
    gen = torch.Generator(device="cpu").manual_seed(0)
    q = torch.randn(B, Sq, H, D, generator=gen).to(dev, torch.bfloat16)
    k = torch.randn(B, Skv, Hkv, D, generator=gen).to(dev, torch.bfloat16)
    v = torch.randn(B, Skv, Hkv, D, generator=gen).to(dev, torch.bfloat16)
    return q, k, v


def _scan_case(dev, B, S, d, N, dtype):
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = (torch.randn(B, S, d, generator=gen) * 0.5).to(dev, dtype)
    dt = (torch.rand(B, S, d, generator=gen) * 0.1).to(dev, dtype)
    Bs = torch.randn(B, S, N, generator=gen).to(dev, dtype)
    Cs = torch.randn(B, S, N, generator=gen).to(dev, dtype)
    A = -torch.rand(d, N, generator=gen).to(dev) - 0.5
    return x, dt, Bs, Cs, A


def _kernel_calls(dev, case):
    """(a call on the card, the same call on meta) for one kernel op."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import meta as kmeta
    if case in ("k1_prefill_lse", "k1_decode_lse_f32", "k1_bwd"):
        Sq = 1 if case == "k1_decode_lse_f32" else 200
        q, k, v = _k1_case(dev, 2, Sq, 300 if Sq == 1 else Sq, 16, 8, 128)
        qm, km, vm = (t.to("meta") for t in (q, k, v))
        if case == "k1_bwd":
            out, lse = fa.flash_attention_cuda(q, k, v, with_lse=True)
            dout = torch.randn_like(out)
            lm = lse.to("meta")
            return (lambda: fa.flash_attention_bwd_cuda(q, k, v, out, dout,
                                                        lse),
                    lambda: kmeta.flash_attention_bwd_meta(qm, km, vm, qm, qm,
                                                           lm))
        kw = dict(with_lse=True, out_f32=Sq == 1,
                  q_offset=torch.tensor([150], dtype=torch.int32,
                                        device=dev) if Sq == 1 else 0)
        fresh = fa.FlashAttentionKernel()   # its first decode launch
        kw_m = dict(kw, q_offset=torch.empty((), dtype=torch.int32,
                                             device="meta")
                    if Sq == 1 else 0)
        return (lambda: fresh(q, k, v, **kw),
                lambda: kmeta.flash_attention_meta(qm, km, vm, **kw_m))
    dtype = torch.bfloat16
    B, S, d, N = 2, 100, 256, 16
    x, dt, Bs, Cs, A = _scan_case(dev, B, S, d, N, dtype)
    xm, dtm, bm, cm, am = (t.to("meta") for t in (x, dt, Bs, Cs, A))
    if case == "k2":
        decay, inc = ss.decay_inc(dt, x, Bs, A)
        C = Cs.float().contiguous()
        dm, im, Cm = (t.to("meta") for t in (decay, inc, C))
        return (lambda: ssm_scan_cuda(decay, inc, C),
                lambda: kmeta.ssm_scan_meta(dm, im, Cm))
    if case == "k2_fused":
        return (lambda: ss.ssm_scan_fused_cuda(x, dt, Bs, Cs, A),
                lambda: kmeta.ssm_scan_fused_meta(xm, dtm, bm, cm, am))
    if case == "k2_fused_states":
        def card():   # as ops.Mamba1ScanFunction allocates them
            states = torch.empty(ss.states_shape(B, S, d, N), device=dev)
            return ss.ssm_scan_fused_cuda(x, dt, Bs, Cs, A, states=states), \
                states
        return card, lambda: kmeta.ssm_scan_fused_meta(
            xm, dtm, bm, cm, am, with_states=True)
    states = torch.empty(ss.states_shape(B, S, d, N), device=dev)
    ss.ssm_scan_fused_cuda(x, dt, Bs, Cs, A, states=states)
    dy = torch.randn(B, S, d, device=dev)
    sm, dym = states.to("meta"), dy.to("meta")
    return (lambda: ss.ssm_scan_bwd_cuda(x, dt, Bs, Cs, A, dy, states),
            lambda: kmeta.ssm_scan_bwd_meta(xm, dtm, bm, cm, am, dym, sm))


@pytest.mark.parametrize("case", ["k1_prefill_lse", "k1_decode_lse_f32",
                                  "k1_bwd", "k2", "k2_fused",
                                  "k2_fused_states", "k2_bwd"])
def test_fake_allocations_match_the_card(cuda, case):
    """Over one launch, the growth of ``memory_allocated`` (what the call
    keeps: outputs, and the decode kernel's workspace on its first
    launch) and of ``max_memory_allocated`` (its temporaries beside them)
    equal the dry-run's tally of the same call on meta tensors."""
    from repro_torch.analysis import costs
    card, meta = _kernel_calls(cuda, case)
    mode = costs.CostMode()
    with mode:
        kept_meta = meta()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    kept = card()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    peak = torch.cuda.max_memory_allocated() - before
    assert grown == mode._live_bytes, (grown, mode._live_bytes)
    assert peak == mode.costs.temp_peak_bytes, (peak,
                                                mode.costs.temp_peak_bytes)
    assert kept is not None and kept_meta is not None
