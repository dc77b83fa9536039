"""The dry-run — production meshes on the ``fake`` process group, abstract
inputs (``launch/specs.py``), the per-chip counts (``analysis/costs.py``)
and ``launch/dryrun.py`` — held against the JAX package's dry-run.

Two subprocesses of this file compute every JAX-side number (``python
tests/test_torch_dryrun.py jax DIR PART``, JAX on host devices forced by
``XLA_FLAGS``, meshes built with ``AxisType.Auto`` axes, as the
reference's constraints need under jax 0.9): part 0 the reference's
``specs`` leaves and ``shard_shape`` on meshes (2, 2), (4, 1), (1, 4) and
(2, 2, 2) for every arch's smoke config, and ``compile_cell`` of qwen3's
and falcon's smoke cells (train and decode) on (2, 2) with the per-chip
FLOPs ``repro.analysis.hlo.analyze`` reads from the compiled HLO; part 1,
on 256 host devices, the reference's own ``make_production_mesh`` under
``compile_cell``.  The port's side runs here, each fake group inside
``launch.mesh.fake_world``, which destroys it on exit.  This module
imports no JAX at its top.

Holds: every leaf's shape, dtype and local block against the reference's;
``model_flops_*`` equal; per-chip product FLOPs equal the reference's
HLO count once each difference by construction (written below as
formulas) is applied; the counter counts one chip's share where
``FlopCounterMode`` counts the global program; the kernels' FLOP formulas
and fake allocations; the memory tracker on a hand-built function; both
reference faults (``ROADMAP.md``, Queue 3); ``run_cells``; no ``jax``
after a dry-run.
"""
import json
import math
import os
import pickle
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import costs  # noqa: E402
from repro_torch.configs import REGISTRY, get_config, smoke  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import meta as kmeta  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as sp  # noqa: E402
from repro_torch.launch.mesh import fake_world  # noqa: E402
from repro_torch.runtime import alloc_bytes  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
MESHES = {"m22": (2, 2), "m41": (4, 1), "m14": (1, 4), "m222": (2, 2, 2)}
TRAIN = ShapeConfig("train", "train", 32, 4)
DECODE = ShapeConfig("decode", "decode", 32, 2)
#: the cells held against the reference's compiled HLO, on (2, 2)
CELLS = [(arch, kind) for arch in ("qwen3-1.7b", "falcon-mamba-7b")
         for kind in ("train", "decode")]
CELL_SHAPES = {"train": ShapeConfig("train", "train", 32, 4),
               "decode": ShapeConfig("decode", "decode", 32, 4)}
#: the reference's faulty production cell (its finding in ROADMAP.md)
FAULT_SHAPE = ShapeConfig("fault", "train", 64, 32)


def _axes(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


# --------------------------------------------------------------------------
# The JAX side, in subprocesses
# --------------------------------------------------------------------------

def _jax_leaves(tree):
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "name", getattr(
            k, "idx", k)))) for k in path)
        out[name] = (tuple(leaf.shape), str(leaf.dtype),
                     tuple(leaf.sharding.shard_shape(leaf.shape)))
    return out


def _jax_specs_and_cells(d):
    import jax
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_config as jget, smoke as jsmoke
    from repro.launch import dryrun as jdr
    from repro.launch import specs as jsp

    def auto_mesh(shape):
        return jax.make_mesh(shape, _axes(shape),
                             axis_types=(AxisType.Auto,) * len(shape))

    out = {"specs": {}, "cells": {}}
    for mname, shape in MESHES.items():
        mesh = auto_mesh(shape)
        for arch in REGISTRY:
            cfg = jsmoke(jget(arch))
            params = jsp.abstract_params(cfg, mesh)
            cache, tokens = jsp.decode_inputs(cfg, DECODE, mesh)
            out["specs"][mname, arch] = _jax_leaves({
                "params": params,
                "opt": jsp.abstract_opt_state(cfg, mesh, params),
                "batch": jsp.train_inputs(cfg, TRAIN, mesh),
                "cache": cache, "tokens": tokens})
    jdr.make_production_mesh = lambda multi_pod=False: auto_mesh((2, 2))
    jdr.get_config = lambda arch: jsmoke(jget(arch))
    jdr.SHAPES = dict(CELL_SHAPES)
    for arch, kind in CELLS:
        rec = jdr.compile_cell(arch, kind, False)
        cfg = jsmoke(jget(arch))
        params = jsp.abstract_params(cfg, auto_mesh((2, 2)))
        state = [params] + ([jsp.abstract_opt_state(cfg, auto_mesh((2, 2)),
                                                    params)]
                            if kind == "train" else [jsp.decode_inputs(
                                cfg, CELL_SHAPES[kind], auto_mesh((2, 2)))[0]])
        leaf_bytes = [int(np.prod(x.shape)) * x.dtype.itemsize
                      for x in jax.tree_util.tree_leaves(state)]
        out["cells"][arch, kind] = dict(
            model_flops_total=rec["model_flops_total"],
            model_flops_per_chip=rec["model_flops_per_chip"],
            hlo_flops=rec["hlo_per_chip"]["flops"],
            hbm_state_bytes_per_device=rec["hbm_state_bytes_per_device"],
            leaf_bytes=leaf_bytes)
    with open(os.path.join(d, "jax-0.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def _jax_fault(d):
    from repro.configs import get_config as jget, smoke as jsmoke
    from repro.launch import dryrun as jdr
    jdr.get_config = lambda arch: jsmoke(jget(arch))
    jdr.SHAPES = {"fault": FAULT_SHAPE}
    try:
        jdr.compile_cell("qwen3-1.7b", "fault", False)
        err = None
    except Exception as e:  # noqa: BLE001 — the fault is the result
        err = (type(e).__name__, str(e)[:300])
    with open(os.path.join(d, "jax-1.pkl"), "wb") as fh:
        pickle.dump({"fault": err}, fh)


JAX_DEVICES = (8, 256)


def _jax_main(d, part):
    [_jax_specs_and_cells, _jax_fault][part](d)


@pytest.fixture(scope="module")
def jax_procs(tmp_path_factory):
    """The JAX subprocesses, started; :func:`ref` reads their results."""
    d = str(tmp_path_factory.mktemp("dryrun"))
    procs = []
    for part, n in enumerate(JAX_DEVICES):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   SCDA_DRYRUN_XLA_FLAGS=f"--xla_force_host_platform_device_"
                                         f"count={n}",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
        env["PYTHONPATH"] = os.pathsep.join(
            [SRC] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                     if p])
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "jax", d, str(part)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    yield d, procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def ref(jax_procs, port_specs, port_cells):
    """The JAX side's numbers, once the port's side (computed meanwhile)
    is done."""
    d, procs = jax_procs
    out = {}
    for part, proc in enumerate(procs):
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, log.decode()[-4000:]
        with open(os.path.join(d, f"jax-{part}.pkl"), "rb") as fh:
            out.update(pickle.load(fh))
    return out


# --------------------------------------------------------------------------
# The port's side
# --------------------------------------------------------------------------

def _local_leaves(tree, prefix=""):
    """name -> (global shape, dtype, local block shape) of meta stand-ins."""
    from torch.distributed.tensor import DTensor
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        local = tree.to_local() if isinstance(tree, DTensor) else tree
        dtype = str(tree.dtype).replace("torch.", "")
        return {prefix[:-1]: (tuple(tree.shape), dtype, tuple(local.shape))}
    for k, v in items:
        out.update(_local_leaves(v, f"{prefix}{k}/"))
    return out


def _port_specs(mesh, cfg):
    params = sp.abstract_params(cfg, mesh)
    cache, tokens = sp.decode_inputs(cfg, DECODE, mesh)
    return _local_leaves({"params": params,
                          "opt": sp.abstract_opt_state(cfg, mesh, params),
                          "batch": sp.train_inputs(cfg, TRAIN, mesh),
                          "cache": cache, "tokens": tokens})


@pytest.fixture(scope="module")
def port_specs():
    from torch.distributed.device_mesh import init_device_mesh
    out = {}
    for n in (4, 8):
        with fake_world(n):
            for mname, shape in MESHES.items():
                if math.prod(shape) != n:
                    continue
                mesh = init_device_mesh("cpu", shape,
                                        mesh_dim_names=_axes(shape))
                for arch in REGISTRY:
                    out[mname, arch] = _port_specs(mesh, smoke(get_config(
                        arch)))
    return out


@pytest.fixture(scope="module")
def port_cells():
    return {(arch, kind): dryrun.trace_cell(
        arch, kind, False, cfg=smoke(get_config(arch)),
        shape=CELL_SHAPES[kind], mesh_shape=(2, 2)) for arch, kind in CELLS}


# --------------------------------------------------------------------------
# 1. specs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_specs_match_the_references_leaves_and_blocks(ref, port_specs, mesh):
    for arch in REGISTRY:
        want = ref["specs"][mesh, arch]
        got = port_specs[mesh, arch]
        assert sorted(got) == sorted(want), (arch, set(got) ^ set(want))
        for name, leaf in want.items():
            assert got[name] == leaf, (arch, name, got[name], leaf)


def test_specs_without_a_mesh_are_plain_meta_tensors():
    cfg = smoke(get_config("qwen3-1.7b"))
    params = sp.abstract_params(cfg, None, torch.bfloat16)
    cache, tokens = sp.decode_inputs(cfg, DECODE, None)
    leaves = list(_local_leaves({"p": params, "c": cache}).values())
    assert all(t.device.type == "meta" for t in (
        params["embed"], cache["k"], tokens))
    assert params["embed"].dtype == torch.bfloat16
    assert all(g == loc for g, _, loc in leaves)


# --------------------------------------------------------------------------
# 2. and 3. model FLOPs, per-chip product FLOPs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_model_flops_equal_the_references(ref, port_cells, cell):
    want, got = ref["cells"][cell], port_cells[cell]
    assert got["model_flops_total"] == want["model_flops_total"]
    assert got["model_flops_per_chip"] == want["model_flops_per_chip"]


def _attention_terms(cfg, shape, kind, data, model):
    """(the reference's attention dots, K1's FLOPs) a chip of a (data,
    model) mesh computes in a step of a dense model.  The reference's
    attention is an online softmax over kv chunks of dots: with one chunk
    (kv_chunk 512 >= S) it computes q·k and p·v for every (query, key)
    pair, masked ones too, 2·S·Skv·D each a (row, head), and its backward
    autodiff's four (dV, dP, dQ, dK); remat runs the forward again.  K1
    computes the attended pairs alone: 4·H·D a pair forward, twice (the
    forward and remat's), 10·H·D backward.  In a decode step a query at
    the cache's last position attends every key, so the two agree."""
    Bl, Hl, D = shape.global_batch // data, cfg.n_heads // model, cfg.head_dim_
    S = 1 if kind == "decode" else shape.seq_len
    Skv = shape.seq_len
    dot = 2 * Bl * Hl * S * Skv * D
    pairs = kmeta.attended_pairs(S, Skv, True, None, Skv - S)
    k1 = Bl * Hl * D * pairs
    if kind == "decode":
        return cfg.n_layers * 2 * dot, cfg.n_layers * 4 * k1
    return cfg.n_layers * (2 * 2 + 4) * dot, cfg.n_layers * (2 * 4 + 10) * k1


def _scan_terms(cfg, shape, data, model):
    """(the reference's scan dots, K2's FLOPs) a chip computes in a train
    step of Mamba1.  The reference's fused core reduces each chunk's
    states against C by a dot, y = Σ_n h·C (2·B·S·d·N), in its forward,
    remat's forward and the backward's dC; the outer product dh = dy ⊗ C
    is no dot.  The fused K2 counts 6 a state element forward (twice) and
    20 backward (``kernels.meta``)."""
    n = (shape.global_batch // data) * shape.seq_len * (
        cfg.d_inner // model) * cfg.ssm_state
    return 3 * 2 * n * cfg.n_layers, (6 + 6 + 20) * n * cfg.n_layers


def _expected_port_flops(cfg, kind, hlo_flops):
    """The reference's per-chip HLO FLOPs turned into the port's, each
    difference by construction a formula (a (2, 2) mesh):

      * attention and the scan: :func:`_attention_terms`,
        :func:`_scan_terms`;
      * k and v: the reference computes the whole kv heads' projections
        on every model rank (its constraint makes them whole), the port
        its rank's heads and gathers them: the reference computes (1 -
        1/m) of 2·T·d·Hkv·D more for each of k and v, in the forward,
        remat's forward and the backward's dX (its dW is a rank's block);
      * the row-parallel products (attention's output and the MLP's down
        projection, ``layers._row_parallel``): their gradient reaches
        DTensor as partial sums over the model axis, and DTensor gathers
        the weight and computes both backward products (dX, dW) whole
        on each model rank: (1 - 1/m) of 2·T·d·(F + H·D) more, twice;
      * Mamba1's x_proj: DTensor computes its two backward products on
        the whole of d_inner: (1 - 1/m) of 2·T·d_inner·(R + 2N), twice.
    """
    data = model = 2
    shape = CELL_SHAPES[kind]
    T = shape.global_batch // data * (1 if kind == "decode"
                                      else shape.seq_len)
    L, d, f = cfg.n_layers, cfg.d_model, 1 - 1 / model
    want = hlo_flops
    if cfg.has_attention:
        ref_attn, k1 = _attention_terms(cfg, shape, kind, data, model)
        passes = 1 if kind == "decode" else 3
        kv = L * passes * 2 * 2 * T * d * cfg.n_kv_heads * cfg.head_dim_ * f
        want += k1 - ref_attn - kv
        if kind == "train":
            want += L * 2 * 2 * T * d * (cfg.d_ff + cfg.n_heads
                                         * cfg.head_dim_) * f
    elif kind == "train":
        ref_scan, k2 = _scan_terms(cfg, shape, data, model)
        R = max(1, d // 16)
        want += k2 - ref_scan + L * 2 * 2 * T * cfg.d_inner * (
            R + 2 * cfg.ssm_state) * f
    return want


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_per_chip_flops_are_the_references_hlo_count(ref, port_cells, cell):
    arch, kind = cell
    want = _expected_port_flops(smoke(get_config(arch)), kind,
                                ref["cells"][cell]["hlo_flops"])
    got = port_cells[cell]["per_chip"]["flops"]
    assert got == pytest.approx(want, rel=1e-12, abs=0), (got, want)


# --------------------------------------------------------------------------
# 4. one chip's share
# --------------------------------------------------------------------------

def test_the_counter_counts_one_chips_share():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed import sharding as sh
    M, K, N = 64, 32, 128
    whole = 2 * M * K * N

    def on(mesh, pl):
        x = sh.target(mesh, sh.P(), torch.empty(M, K, device="meta"))
        w = torch.empty(K, N, device="meta")
        w = sh.target(mesh, pl, w)
        return x, w

    with fake_world(4):
        mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data",
                                                               "model"))
        x, w = on(mesh, sh.P(None, "model"))
        _, c_shard = costs.count(torch.matmul, x, w, mesh=mesh)
        x, w = on(mesh, sh.P())
        _, c_rep = costs.count(torch.matmul, x, w, mesh=mesh)
        assert [type(p) for p in w.placements] == [Replicate, Replicate]
        x, w = on(mesh, sh.P(None, "model"))
        assert isinstance(w.placements[1], Shard)
        with FlopCounterMode(display=False) as global_count:
            torch.matmul(x, w)
    with fake_world(1):
        mesh1 = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                                "model"))
        x, w = on(mesh1, sh.P(None, "model"))
        _, c_one = costs.count(torch.matmul, x, w, mesh=mesh1)
    assert c_one.flops == whole
    assert c_shard.flops == whole / 4
    assert c_rep.flops == whole
    assert global_count.get_total_flops() == whole


def test_a_training_step_on_a_model_axis_counts_its_share():
    """The same qwen3 smoke train step on (1, 4) and on one device: the
    dense products a chip runs shrink with the model axis (the vocab and
    MLP shards), the per-chip count is less than one device's, and
    ``FlopCounterMode`` around the same DTensor step counts more than the
    chip's share (the global program)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed import sharding as sh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step
    cfg = smoke(get_config("qwen3-1.7b"))
    one, _, _ = dryrun.trace_step(cfg, TRAIN, None)
    from torch.distributed.device_mesh import init_device_mesh
    with fake_world(4):
        mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data",
                                                               "model"))
        sh.set_mesh(mesh)
        try:
            four, _, _ = dryrun.trace_step(cfg, TRAIN, mesh)
            params = sp.abstract_params(cfg, mesh)
            opt = sp.abstract_opt_state(cfg, mesh, params)
            batch = sp.train_inputs(cfg, TRAIN, mesh)
            with FlopCounterMode(display=False) as fc:
                make_train_step(cfg, AdamWConfig())(params, opt, batch)
        finally:
            sh.set_mesh(None)
    assert four.flops < one.flops
    assert fc.get_total_flops() > four.flops


# --------------------------------------------------------------------------
# 5. and 6. the kernels' FLOP formulas and fake allocations
# --------------------------------------------------------------------------

def _k1_fwd_flops(B, S, H, Hkv, D, causal=True, window=None, Skv=None):
    Skv = Skv or S
    q = torch.empty(B, S, H, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, Skv, Hkv, D, dtype=torch.bfloat16, device="meta")
    _, c = costs.count(kmeta.flash_attention_meta, q, k, k, causal=causal,
                       window=window)
    return c.flops


def _k1_bwd_flops(B, S, H, Hkv, D, causal=True, window=None, Skv=None):
    Skv = Skv or S
    q = torch.empty(B, S, H, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, Skv, Hkv, D, dtype=torch.bfloat16, device="meta")
    lse = torch.empty(B, H, S, device="meta")
    _, c = costs.count(kmeta.flash_attention_bwd_meta, q, k, k, q, q, lse,
                       causal=causal, window=window)
    return c.flops


@pytest.mark.parametrize("case,want", [
    # PERF.md §6's bound column, operations (FLOP)
    (("fwd", 8, 1024, 16, 8, 128), 34_393_292_800),
    (("bwd", 8, 1024, 16, 8, 128), 85_983_232_000),
    (("fwd", 1, 4096, 8, 4, 256), 68_736_253_952),
    (("bwd", 8, 1024, 32, 32, 80), 107_479_040_000),
    (("bwd", 2, 4096, 8, 4, 256), 343_681_269_760),
    (("bwd", 8, 1024, 24, 8, 64), 64_487_424_000),
    (("fwd", 4, 1500, 16, 16, 64, False), 36_864_000_000),
    (("fwd", 4, 448, 16, 16, 64, False, None, 1500), 11_010_048_000),
    (("bwd", 8, 1500, 16, 16, 64, False), 184_320_000_000),
    (("bwd", 8, 448, 16, 16, 64, False, None, 1500), 55_050_240_000),
    (("fwd", 4, 3392, 32, 8, 128), 377_128_747_008),
    (("bwd", 2, 3904, 32, 8, 128), 624_440_115_200),
    # the 1024-key window over 4096 positions: Σ min(p + 1, 1024) pairs,
    # chip_smoke.py's count (PERF.md §6 once had the forward's mistyped
    # as 30,069,964,800)
    (("fwd", 1, 4096, 8, 4, 256, True, 1024), 30_068_965_376),
    (("bwd", 2, 4096, 8, 4, 256, True, 1024), 150_344_826_880),
])
def test_k1_flop_formulas_give_the_bound_counts(case, want):
    fn = _k1_fwd_flops if case[0] == "fwd" else _k1_bwd_flops
    assert fn(*case[1:]) == want


def test_attended_pairs_counts_the_masks():
    brute = lambda Sq, Skv, causal, window, off: sum(  # noqa: E731
        1 for i in range(Sq) for j in range(Skv)
        if (not causal or j <= off + i)
        and (window is None or off + i - j < window))
    for args in [(7, 7, True, None, 0), (5, 9, True, 3, 4), (4, 6, False,
                 None, 0), (3, 8, False, 2, 5), (1, 16, True, None, -2),
                 (6, 4, True, 2, 10)]:
        assert kmeta.attended_pairs(*args) == brute(*args), args


def test_k2_flop_formulas():
    B, S, d, N = 2, 48, 64, 16
    decay = torch.empty(B, S, d, N, device="meta")
    C = torch.empty(B, S, N, device="meta")
    _, c = costs.count(kmeta.ssm_scan_meta, decay, decay, C)
    assert c.flops == 4 * B * S * d * N
    x = torch.empty(B, S, d, dtype=torch.bfloat16, device="meta")
    Bs = torch.empty(B, S, N, dtype=torch.bfloat16, device="meta")
    A = torch.empty(d, N, device="meta")
    _, c = costs.count(kmeta.ssm_scan_fused_meta, x, x, Bs, Bs, A)
    assert c.flops == 6 * B * S * d * N
    assert c.flops_by_dtype == {"float32": 6 * B * S * d * N}
    states = torch.empty(ss.states_shape(B, S, d, N), device="meta")
    dy = torch.empty(B, S, d, device="meta")
    _, c = costs.count(kmeta.ssm_scan_bwd_meta, x, x, Bs, Bs, A, dy, states)
    assert c.flops == 20 * B * S * d * N


def _shapes(ts):
    return [(tuple(t.shape), t.dtype) for t in ts]


@pytest.mark.parametrize("Sq,lse,f32", [(37, False, False), (37, True, False),
                                        (1, False, False), (1, True, False),
                                        (1, True, True)])
def test_k1_fakes_allocate_what_the_launcher_allocates(Sq, lse, f32):
    B, H, Hkv, D, Skv = 2, 8, 2, 64, 300
    q = torch.empty(B, Sq, H, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, Skv, Hkv, D, dtype=torch.bfloat16, device="meta")
    out = kmeta.flash_attention_meta(q, k, k, with_lse=lse, out_f32=f32)
    outs = list(out) if lse else [out]
    allocs = fa.fwd_allocs(B, Sq, H, D, Skv, Hkv, torch.bfloat16,
                           with_lse=lse, out_f32=f32)
    assert _shapes(outs) == list(allocs.outputs)
    assert alloc_bytes(allocs.outputs) == sum(costs.tensor_bytes(t)
                                              for t in outs)
    plan = fa.decode_plan(Skv, B=B, Hkv=Hkv, group=H // Hkv, D=D)
    assert allocs.workspace == ((((plan.scratch_floats,), torch.float32),
                                 ((plan.tickets,), torch.int32))
                                if Sq == 1 else ())
    _, c = costs.count(kmeta.flash_attention_meta, q, k, k, with_lse=lse,
                       out_f32=f32, round_to=1)
    assert c.workspace_bytes == alloc_bytes(allocs.workspace)
    assert c.temp_peak_bytes == alloc_bytes(allocs.outputs) + alloc_bytes(
        allocs.workspace)


def test_k1_bwd_fake_allocates_what_the_launcher_allocates():
    B, S, H, Hkv, D = 2, 33, 8, 2, 128
    q = torch.empty(B, S, H, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, S, Hkv, D, dtype=torch.bfloat16, device="meta")
    lse = torch.empty(B, H, S, device="meta")
    got = kmeta.flash_attention_bwd_meta(q, k, k, q, q, lse)
    allocs = fa.bwd_allocs(B, S, H, D, S, Hkv, torch.bfloat16)
    assert _shapes(got) == list(allocs.outputs)
    assert allocs.temps == (((B, H, S), torch.float32),)
    _, c = costs.count(kmeta.flash_attention_bwd_meta, q, k, k, q, q, lse,
                       round_to=1)
    assert c.temp_peak_bytes == alloc_bytes(allocs.outputs) + alloc_bytes(
        allocs.temps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_fakes_allocate_what_the_launchers_allocate(dtype):
    B, S, d, N = 2, 40, 96, 16
    x = torch.empty(B, S, d, dtype=dtype, device="meta")
    Bs = torch.empty(B, S, N, dtype=dtype, device="meta")
    A = torch.empty(d, N, device="meta")
    y = kmeta.ssm_scan_meta(torch.empty(B, S, d, N, device="meta"),
                            torch.empty(B, S, d, N, device="meta"),
                            torch.empty(B, S, N, device="meta"))
    assert _shapes([y]) == list(ss.scan_allocs(B, S, d, N).outputs)
    for st in (False, True):
        got = kmeta.ssm_scan_fused_meta(x, x, Bs, Bs, A, with_states=st)
        got = list(got) if st else [got]
        assert _shapes(got) == list(ss.fused_allocs(B, S, d, N, st).outputs)
    states = torch.empty(ss.states_shape(B, S, d, N), device="meta")
    dy = torch.empty(B, S, d, device="meta")
    got = kmeta.ssm_scan_bwd_meta(x, x, Bs, Bs, A, dy, states)
    allocs = ss.bwd_allocs(B, S, d, N, dtype, dtype, dtype, dtype)
    assert _shapes(got) == list(allocs.outputs)
    plan = ss.bwd_plan(B, S, d, N, dtype.itemsize, True)
    casts = 0 if dtype == torch.float32 else 2
    assert allocs.temps == tuple((s, torch.float32) for s in plan.partials) \
        + (((B, S, N), torch.float32),) * casts
    _, c = costs.count(kmeta.ssm_scan_bwd_meta, x, x, Bs, Bs, A, dy, states,
                       round_to=1)
    assert c.temp_peak_bytes == alloc_bytes(allocs.outputs) + alloc_bytes(
        allocs.temps)


def test_meta_tensors_never_reach_a_launch_and_other_devices_raise():
    from repro_torch.kernels import ops
    q = torch.empty(1, 4, 2, 16, device="meta")
    before = fa.flash_attention_cuda.launches
    out = ops.flash_attention(q, q, q)
    assert out.device.type == "meta" and fa.flash_attention_cuda.launches \
        == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="meta tensors"):
        kmeta.ssm_scan_meta(*(torch.empty(1, 2, 3, 4),) * 2,
                            torch.empty(1, 2, 4))
    with pytest.raises(ValueError, match="takes meta tensors"):
        torch.ops.repro.k2(*(torch.empty(1, 2, 3, 4),) * 2,
                           torch.empty(1, 2, 4))


# --------------------------------------------------------------------------
# 7. the memory tracker
# --------------------------------------------------------------------------

def test_the_memory_tracker_is_exact_on_a_hand_built_function():
    """Allocations, a free, an in-place op, a view and a tensor autograd
    saves for the backward, in f32 on meta: n = 64 * 32 * 4 bytes."""
    n = 64 * 32 * 4

    def fn(x, w):
        a = x * 2                  # +n            live n
        b = a + 1                  # +n            live 2n
        del a                      # -n            live n
        b.add_(1)                  # in place: nothing
        v = b.view(-1)             # a view: nothing
        y = (b * w).sum()          # +n, +4, -n    peak 2n + 4; the product
        return y, v                # saves b for w's gradient

    x = torch.empty(64, 32, device="meta")
    w = torch.empty(64, 32, device="meta", requires_grad=True)
    mode = costs.CostMode(round_to=1)
    with mode:
        y, v = fn(x, w)
        live = [mode._live_bytes]          # b (saved, and v's) and y
        del v
        live.append(mode._live_bytes)      # b, saved for the backward
        # the backward: y's gradient (+4), then w's, ones * b (+n); the
        # graph's end frees the seed and b
        grad = torch.autograd.grad(y, w)[0]
        live.append(mode._live_bytes)      # y and w's gradient
        del y
        live.append(mode._live_bytes)
    assert live == [n + 4, n + 4, n + 4, n]
    assert mode.costs.temp_peak_bytes == 2 * n + 8
    assert grad.shape == (64, 32)


def test_rounding_is_the_allocators():
    assert costs.rounded(0) == 0
    assert costs.rounded(1) == 512
    assert costs.rounded(512) == 512
    assert costs.rounded(513) == 1024


# --------------------------------------------------------------------------
# 8. the reference's faults
# --------------------------------------------------------------------------

def test_the_references_production_mesh_fails_to_compile(ref):
    name, msg = ref["fault"]
    assert name == "ShardingTypeError", (name, msg)


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_state_bytes_the_reference_divides_by_the_mesh_the_port_counts_blocks(
        ref, port_cells, cell):
    arch, kind = cell
    want = ref["cells"][cell]
    # the reference: each leaf's bytes over the mesh's 4 devices, sharded
    # or not (``leaf.sharding.num_devices``)
    assert want["hbm_state_bytes_per_device"] == sum(
        b // 4 for b in want["leaf_bytes"])
    # the port: each leaf's local block, as the reference's own
    # ``shard_shape`` gives it, plus the cache in a decode cell
    blocks = ref["specs"]["m22", arch]
    kinds = ("params/",) + (("opt/",) if kind == "train" else ())
    state = sum(math.prod(local) * torch.empty((), dtype=getattr(
        torch, dtype)).element_size() for name, (_, dtype, local) in
        blocks.items() if name.startswith(kinds))
    got = port_cells[cell]["hbm_state_bytes_per_device"]
    if kind == "decode":
        # the served weights (the compute dtype: f32 in a smoke config)
        # and the cache, each leaf's local block
        from torch.distributed.device_mesh import init_device_mesh
        cfg = smoke(get_config(arch))
        with fake_world(4):
            mesh = init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("data", "model"))
            cache, _ = sp.decode_inputs(cfg, CELL_SHAPES[kind], mesh)
            cache_leaves = _local_leaves(cache)
        state = sum(math.prod(loc) * torch.empty((), dtype=getattr(
            torch, dt)).element_size() for _, dt, loc in
            cache_leaves.values()) + sum(
            math.prod(loc) * 4 for name, (_, _, loc) in blocks.items()
            if name.startswith("params/"))
    assert got == state
    assert got != want["hbm_state_bytes_per_device"]


# --------------------------------------------------------------------------
# 9. run_cells; 10. no jax
# --------------------------------------------------------------------------

def test_run_cells_writes_skips_done_and_reports_failures(tmp_path, capsys):
    out = str(tmp_path / "sub" / "dryrun.json")
    traced = []

    def trace(arch, shape_name, multi_pod, kv_chunk, loss_chunk):
        traced.append((arch, shape_name))
        if arch == "broken":
            raise RuntimeError("a cell that fails")
        rec = dryrun.trace_cell(arch, shape_name, False,
                                cfg=smoke(get_config(arch)),
                                shape=CELL_SHAPES[shape_name],
                                mesh_shape=(2, 2))
        rec["mesh"] = [2, 16, 16] if multi_pod else [16, 16]
        return rec

    cells = [("qwen3-1.7b", "decode", False), ("broken", "decode", False),
             ("falcon-mamba-7b", "decode", False)]
    failures = dryrun.run_cells(cells, out, 512, 256, trace=trace)
    assert [f[0] for f in failures] == ["broken × decode × 16x16"]
    with open(out) as fh:
        recs = json.load(fh)
    assert [(r["arch"], r["shape"]) for r in recs] == [
        ("qwen3-1.7b", "decode"), ("falcon-mamba-7b", "decode")]
    for r in recs:
        assert r["fits"] and "not measured" in r["predicted"]
        assert r["roofline"]["dominant"] in ("compute", "memory",
                                             "collective")
    traced.clear()
    failures = dryrun.run_cells(cells, out, 512, 256, trace=trace)
    assert traced == [("broken", "decode")] and len(failures) == 1
    assert "skip qwen3-1.7b × decode × 16x16 (done)" in capsys.readouterr().out
    with open(out) as fh:
        assert len(json.load(fh)) == 2


def test_main_exits_1_when_a_cell_fails(tmp_path):
    out = str(tmp_path / "d.json")
    assert dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                        "--out", out]) == 1


def test_a_dry_run_imports_no_jax():
    code = (
        "import sys\n"
        "from repro_torch.configs import get_config, smoke\n"
        "from repro_torch.configs.base import ShapeConfig\n"
        "from repro_torch.launch import dryrun\n"
        "rec = dryrun.trace_cell('falcon-mamba-7b', 't', False, "
        "cfg=smoke(get_config('falcon-mamba-7b')), "
        "shape=ShapeConfig('t', 'train', 16, 4), mesh_shape=(2, 2))\n"
        "assert rec['per_chip']['flops'] > 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), \
        proc.stdout + proc.stderr


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    _jax_main(sys.argv[2], int(sys.argv[3]))
