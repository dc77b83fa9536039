"""The walks of K1's bf16 backward kernels, as ``bwd_plan`` describes them.

The dK/dV kernel's warpgroups own 64 keys and walk tiles of 64 query
positions, once for each q head of the group; the dQ kernel's own 64
positions and walk tiles of 64 keys.  At head dim 256 a block owns one
tile of 64 rows, whose products its two warpgroups split.  Held here on
the CPU against the masks themselves: every valid (position, key) pair of
every q head lies in exactly one visited tile of each walk, no visited
tile is wholly masked, and a tile the kernel computes without masks holds
no masked pair.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (BWD_TILE, BWD_WIDE,  # noqa: E402
                                                 bwd_plan)
from test_torch_gpu import BWD_CASES  # noqa: E402

T = BWD_TILE


def _valid(Sq, Skv, causal, window, q_offset):
    """(Sq, Skv) bool: the pairs the forward's masks let through."""
    pos = q_offset + np.arange(Sq)[:, None]
    key = np.arange(Skv)[None, :]
    ok = np.ones((Sq, Skv), dtype=bool)
    if causal:
        ok &= key <= pos
    if window is not None:
        ok &= pos - key < window
    return ok


def _tiles(blocks):
    """(own rows, walked start, masked) of every tile a warpgroup computes."""
    for blk in blocks:
        for walk in blk.walks:
            for start, masked in walk.tiles:
                yield walk.rows, start, masked


def _hold(plan, Sq, Skv, causal, window, q_offset):
    valid = _valid(Sq, Skv, causal, window, q_offset)
    # the (T x T) rectangle of (position, key) pairs a warpgroup computes
    # for a tile, padded past Sq and Skv
    padded = np.zeros((Sq + 2 * plan.block, Skv + 2 * plan.block), dtype=bool)
    padded[:Sq, :Skv] = valid
    for blocks, as_pk in ((plan.dkdv, lambda rows, t: (t, rows)),
                          (plan.dq, lambda rows, t: (rows, t))):
        counts = np.zeros_like(padded, dtype=np.int64)
        for rows, start, masked in _tiles(blocks):
            p0, k0 = as_pk(rows, start)
            assert p0 >= 0 and k0 >= 0 and p0 < Sq and k0 < Skv
            rect = padded[p0:p0 + T, k0:k0 + T]
            assert rect.any(), f"tile ({p0}, {k0}) is wholly masked"
            if not masked:
                assert p0 + T <= Sq and k0 + T <= Skv and rect.all(), \
                    f"tile ({p0}, {k0}) holds a masked pair"
            counts[p0:p0 + T, k0:k0 + T] += 1
        got = counts[:Sq, :Skv]
        assert (got[valid] == 1).all(), "a valid pair is missed or visited twice"
    # The walks are one q head's.  Masks depend on the position alone, so
    # each head of a group walks the same tiles (dK/dV: the heads one after
    # another in the block; dQ: a block per head) and its pairs are covered
    # as the first head's are.


def _hold_blocks(plan, Sq, Skv):
    rows = plan.block
    assert len(plan.dkdv) == -(-Skv // rows)
    assert len(plan.dq) == -(-Sq // rows)
    for blk in plan.dkdv + plan.dq:
        used = sorted({t for w in blk.walks for t, _ in w.tiles})
        assert list(blk.tiles) == used
        if used:   # the kernel loads one contiguous run of tiles
            assert used == list(range(used[0], used[-1] + T, T))
    for blocks in (plan.dkdv, plan.dq):
        for i, blk in enumerate(blocks):
            assert [w.rows for w in blk.walks] == list(
                range(i * rows, (i + 1) * rows, T))


def _case_id(c):
    return "Sq{}-Skv{}-g{}-{}-w{}-off{}-D{}".format(*c)


GPU_CASES = [(Sq, Skv, H // Hkv, causal, window, q_offset, D)
             for B, H, Hkv, Sq, Skv, D, causal, window, q_offset in BWD_CASES]
SWEEP = [(Sq, Skv, g, causal, window, q_offset, D)
         for Sq, Skv in ((1, 1), (1, 300), (63, 63), (64, 64), (65, 130),
                         (129, 257), (200, 100))
         for causal in (True, False)
         for window in (None, 0, 1, 61, 70)
         for q_offset, g in ((0, 1), (62, 3), (100, 2))
         for D in (128, BWD_WIDE)]


@pytest.mark.parametrize("case", GPU_CASES + SWEEP, ids=_case_id)
def test_walks_cover_every_valid_pair_once(case):
    Sq, Skv, group, causal, window, q_offset, D = case
    plan = bwd_plan(Sq, Skv, group, causal, window, q_offset, D)
    assert plan.block == (T if D == BWD_WIDE else 2 * T)
    _hold(plan, Sq, Skv, causal, window, q_offset)
    _hold_blocks(plan, Sq, Skv)


def test_plan_sizes_the_training_grids():
    """qwen3-1.7b's training shape: 8 blocks each way, and the causal
    walks' length (the dK/dV block of the first keys sees every tile)."""
    plan = bwd_plan(1024, 1024, 2)
    assert (len(plan.dkdv), len(plan.dq)) == (8, 8)
    assert len(plan.dkdv[0].tiles) == 16 and len(plan.dkdv[-1].tiles) == 2
    assert len(plan.dq[0].tiles) == 2 and len(plan.dq[-1].tiles) == 16
    # masks only on the diagonal tiles: one per causal walk of a warpgroup
    for blocks in (plan.dkdv, plan.dq):
        for blk in blocks:
            for walk in blk.walks:
                assert sum(m for _, m in walk.tiles) == 1


def test_plan_sizes_gemma3s_training_grids():
    """gemma3-4b's training shape at head dim 256 (2 x 4096, group 2):
    blocks of one 64-row tile, 64 each way.  Causal (its global layers),
    the dK/dV block of the first keys walks all 64 tiles, masks on the
    diagonal alone; with the 1024-key window (its local layers) an inner
    block walks 17 tiles, masks on two: the diagonal and the window's
    edge."""
    causal = bwd_plan(4096, 4096, 2, D=BWD_WIDE)
    assert (causal.block, len(causal.dkdv), len(causal.dq)) == (T, 64, 64)
    assert len(causal.dkdv[0].tiles) == 64 and len(causal.dkdv[-1].tiles) == 1
    assert len(causal.dq[0].tiles) == 1 and len(causal.dq[-1].tiles) == 64
    for blk in causal.dkdv + causal.dq:
        (walk,) = blk.walks
        assert sum(m for _, m in walk.tiles) == 1
    local = bwd_plan(4096, 4096, 2, True, 1024, D=BWD_WIDE)
    for blocks, first in ((local.dkdv, lambda i: i), (local.dq,
                                                      lambda i: i - 16)):
        (walk,) = blocks[20].walks
        starts = [t for t, _ in walk.tiles]
        assert starts == [T * (first(20) + n) for n in range(17)]
        assert [t for t, m in walk.tiles if m] == [starts[0], starts[-1]]


def test_plan_refuses_empty_shapes():
    with pytest.raises(ValueError):
        bwd_plan(0, 5)
