"""The model path under a device mesh on spawned gloo ranks, held against
the JAX package under the same meshes — the port of the ambient policy
(``distributed/sharding.py``), exact head and expert padding, sequence-
parallel decode and FSDP + TP training.

The meshes are (2, 2) and (4, 1) on one spawn of 4 CPU ranks and (1, 3)
on one spawn of 3 (``repro_torch.distributed.ranks.spawn_ranks``); two
subprocesses of this file (``python tests/test_torch_dist_model.py jax
DIR PART``, ``XLA_FLAGS=--xla_force_host_platform_device_count=4``), run
side by side, compute every JAX-side number on meshes built with
``AxisType.Auto`` axes (the reference's ``constrain`` takes no Explicit
ones).  The inputs are made
here from seeds (weights by the port's ``init_lm``, tokens by numpy) and
written where both read them.  Holds at rtol = atol = 1e-5 unless named:

  * ``constrain``'s specs and ``input_shardings`` against the reference's;
  * ``lm_loss`` and its gradients of five archs under (2, 2) and (4, 1)
    against the JAX package's under the same meshes, and under (1, 3)
    against its no-mesh ones: the reference pads GQA heads after the last
    kv group, which changes the function (ROADMAP.md, Queue 3); the port
    pads each group;
  * padded attention and the MoE block under (1, 3) against no mesh, and
    MHA attention and ``moe_block`` also against the reference's padded
    result;
  * decode steps under (2, 2) and (4, 1) against the reference's; SP
    decode on (4, 1) against the reference's ``_sp_decode_attention`` and
    the plain decode;
  * three training steps under (2, 2), then a resume under (4, 1),
    against the JAX package's single-device loop from the same state;
  * the launcher's ``--data-par 2 --model-par 2`` run and its resume
    under ``--data-par 4 --model-par 1``.

The rank bodies are module-level functions (spawn pickles them by
reference) and this module imports no JAX at its top: the JAX code runs
in the subprocess alone.
"""
import concurrent.futures
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed.ranks import spawn_ranks  # noqa: E402

AXES = ("data", "model")
MESHES = {"m22": (2, 2), "m41": (4, 1), "m13": (1, 3)}
#: The archs whose loss and gradients are held under every mesh.
LOSS_ARCHS = ("qwen3-1.7b", "gemma3-4b", "granite-moe-3b-a800m",
              "falcon-mamba-7b", "zamba2-2.7b")
#: The archs whose decode steps are held under (2, 2) and (4, 1).
SERVE_ARCHS = ("qwen3-1.7b", "gemma3-4b")
INPUT_ARCHS = ("qwen3-1.7b", "falcon-mamba-7b", "zamba2-2.7b",
               "whisper-medium")
B, S, CHUNK = 4, 16, 8
SERVE_LEN, SERVE_POS, SERVE_STEPS = 16, 5, 3
#: SP decode: one request, a cache of 32 (8 a rank of (4, 1)); the
#: position in the first, a middle and the last shard, with a window.
SP_LEN = 32
SP_CASES = [(3, None), (13, None), (30, None), (13, 6), (30, 6)]
#: Training: steps 1-3 under (2, 2) (checkpoint 0 is the shared initial
#: state), saved at 3 and killed; steps 4-5 resumed under (4, 1).
TRAIN_STEPS, TRAIN_SAVE = 6, 3
TRAIN_LR = dict(lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS)
TOL = dict(rtol=1e-5, atol=1e-5)
#: (shape, roles) of the ``constrain`` cases: every role, dims that the
#: axes divide and dims they do not, fewer roles than dims.
CONSTRAIN_CASES = [
    ((4, 6, 8), ("batch", None, "model")),
    ((3, 6, 8), ("batch", None, "model")),
    ((4, 7, 9), ("seq_data", None, "model")),
    ((8, 12), ("seq_model", "seq_data")),
    ((6, 4, 3, 16), ("batch", None, "model", None)),
    ((12, 5), (None, "model")),
    ((4, 6, 8), ("model", "batch")),
    ((2, 4), (None, None)),
]


def _smoke(arch):
    from repro_torch.configs import get_config, smoke
    return smoke(get_config(arch))


def _names(tree):
    from repro_torch.checkpoint.pytree_io import flatten_named
    return flatten_named(tree)[0]


def _np(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy().copy()


# --------------------------------------------------------------------------
# The inputs, written by the test process for both sides
# --------------------------------------------------------------------------

def _write_inputs(d):
    """Seeded weights (the port's ``init_lm``) of every arch as scda files
    with the reference's vendor, checkpoint 0 of the training run in two
    directories, and the numpy inputs in ``inputs.npz``."""
    from repro_torch.checkpoint import save
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.checkpoint.pytree_io import REFERENCE_VENDOR
    from repro_torch.models import init_lm
    from repro_torch.train.loop import init_state
    for i, arch in enumerate(LOSS_ARCHS):
        save(os.path.join(d, f"params-{arch}.scda"),
             init_lm(_smoke(arch), i, device="cpu"), step=0,
             vendor=REFERENCE_VENDOR)
    for run in ("jax-run", "port-run"):
        with CheckpointManager(os.path.join(d, run), shards=0, delta=False,
                               vendor=REFERENCE_VENDOR) as mgr:
            mgr.save(0, init_state(_smoke(LOSS_ARCHS[0]), 7, "cpu"),
                     blocking=True)
    rng = np.random.default_rng(27)
    cfg = _smoke(LOSS_ARCHS[0])
    seq = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    hd, d_model = cfg.head_dim_, cfg.d_model
    arrays = dict(tokens=seq[:, :-1], labels=seq[:, 1:],
                  serve_tokens=rng.integers(0, cfg.vocab, (B, SERVE_STEPS))
                  .astype(np.int32),
                  x_attn=rng.standard_normal((2, 12, d_model))
                  .astype(np.float32),
                  x_dec=rng.standard_normal((1, 1, d_model))
                  .astype(np.float32))
    for name, heads in (("gqa", (4, 2)), ("mha", (4, 4))):
        H, Hkv = heads
        for w, shape in (("wq", (d_model, H, hd)), ("wk", (d_model, Hkv, hd)),
                         ("wv", (d_model, Hkv, hd)),
                         ("wo", (H, hd, d_model))):
            arrays[f"{name}_{w}"] = (rng.standard_normal(shape) * 0.2) \
                .astype(np.float32)
    for key in ("sp_k", "sp_v"):
        arrays[key] = rng.standard_normal((1, SP_LEN, 2, hd)) \
            .astype(np.float32)
    for arch in SERVE_ARCHS:
        c = _smoke(arch)
        for key in ("k", "v"):
            arrays[f"serve_{arch}_{key}"] = rng.standard_normal(
                (c.n_layers, B, SERVE_LEN, c.n_kv_heads, c.head_dim_)) \
                .astype(np.float32)
    np.savez(os.path.join(d, "inputs.npz"), **arrays)


def _inputs(d):
    with np.load(os.path.join(d, "inputs.npz")) as z:
        return {k: z[k] for k in z.files}


def _attn_params(inputs, name):
    return {w: inputs[f"{name}_{w}"] for w in ("wq", "wk", "wv", "wo")}


# --------------------------------------------------------------------------
# The ranks (the port)
# --------------------------------------------------------------------------

def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=AXES)


def _params_on(d, arch, mesh):
    """``arch``'s weights restored onto the placement rules' DTensors."""
    from repro_torch.checkpoint import restore
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import init_lm
    like = sh.params_shardings(mesh, init_lm(_smoke(arch), device="meta"))
    return restore(os.path.join(d, f"params-{arch}.scda"), like=like)[0]


def _loss_and_grads(cfg, params, tokens, labels):
    """The mesh's ``lm_loss`` and every gradient, whole, as numpy."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import lm
    named = _names(params)
    leaves = [p.detach().requires_grad_(True) for _, p in named]
    from repro_torch.checkpoint.pytree_io import flatten_named
    rebuild = flatten_named(params)[1]
    with sh.mesh_region():
        loss = lm.lm_loss(cfg, rebuild(leaves), tokens, labels,
                          loss_chunk=CHUNK, remat=False)
        grads = torch.autograd.grad(loss, leaves)
    return float(_np(loss)), {n: _np(g) for (n, _), g in zip(named, grads)}


def _batch(inputs, mesh):
    from repro_torch.distributed import sharding as sh
    spec = sh.batch_spec(mesh, 2)
    return (sh.distribute(torch.from_numpy(inputs["tokens"]), mesh, spec),
            sh.distribute(torch.from_numpy(inputs["labels"]).long(), mesh,
                          spec))


def _losses_on(d, inputs, mesh, out, key):
    from repro_torch.distributed import sharding as sh
    sh.set_mesh(mesh)
    tok, lab = _batch(inputs, mesh)
    for arch in LOSS_ARCHS:
        out[(key, "loss", arch)] = _loss_and_grads(
            _smoke(arch), _params_on(d, arch, mesh), tok, lab)
    # constrain's placements, on a real mesh
    for i, (shape, roles) in enumerate(CONSTRAIN_CASES):
        y = sh.constrain(torch.zeros(shape), *roles)
        out[(key, "constrain", i)] = [str(p) for p in y.placements]
    sh.set_mesh(None)


def _serve_on(d, inputs, mesh, out, key):
    """SERVE_STEPS decode steps from SERVE_POS of a seeded cache."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import lm
    sh.set_mesh(mesh)
    for arch in SERVE_ARCHS:
        cfg = _smoke(arch)
        params = _params_on(d, arch, mesh)
        cache = lm.init_cache(cfg, B, SERVE_LEN, device="cpu", mesh=mesh)
        for k in ("k", "v"):
            whole = sh.distribute(torch.from_numpy(
                inputs[f"serve_{arch}_{k}"]), mesh, sh.P())
            cache[k].to_local().copy_(
                whole.redistribute(mesh, cache[k].placements).to_local())
        cache["pos"].fill_(SERVE_POS)
        logits = []
        for i in range(SERVE_STEPS):
            tok = torch.from_numpy(inputs["serve_tokens"][:, i:i + 1])
            got, cache = lm.serve_step(cfg, params, cache, tok)
            logits.append(_np(got))
        out[(key, "serve", arch)] = (logits, _np(cache["k"]),
                                     int(cache["pos"]))
    sh.set_mesh(None)


def _sp_decode(inputs, mesh, out):
    """One attention layer's decode with the cache sequence-sharded on
    (4, 1)'s data axis (``sp_decode_axis``), for each of SP_CASES."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import layers as L
    cfg = smoke(get_config(LOSS_ARCHS[0]))
    p = {k: torch.from_numpy(v) for k, v in _attn_params(inputs,
                                                         "gqa").items()}
    sh.set_mesh(mesh, sp_decode_axis="data")
    spec = sh.P(None, "data", None, None)
    for pos, window in SP_CASES:
        ck = sh.distribute(torch.from_numpy(inputs["sp_k"]).clone(), mesh,
                           spec)
        cv = sh.distribute(torch.from_numpy(inputs["sp_v"]).clone(), mesh,
                           spec)
        y, ck, cv = L.attention_decode(
            p, torch.from_numpy(inputs["x_dec"]), ck, cv,
            torch.tensor(pos, dtype=torch.int32), n_heads=4, n_kv=2,
            head_dim=cfg.head_dim_, rope_base=cfg.rope_base, window=window)
        out[("sp", pos, window)] = (_np(y), _np(ck), _np(cv))
    sh.set_mesh(None)


def _train_on(d, tp_mesh, sp_mesh, out):
    """Steps 1-3 under (2, 2) from checkpoint 0, killed after the step-3
    save; then the resume under (4, 1) to the end."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainLoopConfig, train
    cfg = _smoke(LOSS_ARCHS[0])
    loop = TrainLoopConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_SAVE,
                           ckpt_dir=os.path.join(d, "port-run"),
                           log_every=100)
    losses = {}

    def on_step(step, state, metrics):
        losses[step] = float(metrics["loss"])

    try:
        train(cfg, loop, AdamWConfig(**TRAIN_LR), seq_len=S,
              global_batch=B, device="cpu", mesh=tp_mesh,
              hooks={"on_step": on_step,
                     "should_die": lambda s: s == TRAIN_SAVE})
    except SystemExit:
        pass
    res = train(cfg, loop, AdamWConfig(**TRAIN_LR), seq_len=S,
                global_batch=B, device="cpu", mesh=sp_mesh,
                hooks={"on_step": on_step})
    res["manager"].close()
    out["train"] = dict(losses=[losses[s] for s in sorted(losses)],
                        start=res["start_step"])


def _rank4(d):
    """Every rank-side step on 4 ranks: (2, 2) and (4, 1)."""
    torch.set_num_threads(1)
    inputs = _inputs(d)
    out = {}
    meshes = {k: _mesh(MESHES[k]) for k in ("m22", "m41")}
    for key, mesh in meshes.items():
        _losses_on(d, inputs, mesh, out, key)
        _serve_on(d, inputs, mesh, out, key)
    _sp_decode(inputs, meshes["m41"], out)
    _train_on(d, meshes["m22"], meshes["m41"], out)
    return out if torch.distributed.get_rank() == 0 else None


def _rank3(d):
    """Every rank-side step on 3 ranks: (1, 3), where heads (4) and
    experts (4) do not divide the model axis and are padded."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import layers as L
    torch.set_num_threads(1)
    inputs = _inputs(d)
    mesh = _mesh(MESHES["m13"])
    out = {}
    _losses_on(d, inputs, mesh, out, "m13")
    sh.set_mesh(mesh)
    cfg = smoke(get_config(LOSS_ARCHS[0]))
    x = torch.from_numpy(inputs["x_attn"])
    for name, (H, Hkv) in (("gqa", (4, 2)), ("mha", (4, 4))):
        p = {k: torch.from_numpy(v)
             for k, v in _attn_params(inputs, name).items()}
        y = L.attention_block(p, x, n_heads=H, n_kv=Hkv,
                              head_dim=cfg.head_dim_,
                              rope_base=cfg.rope_base)
        out[("attn", name)] = _np(y)
    gcfg = _smoke("granite-moe-3b-a800m")
    moe = {k: v[0] for k, v in _params_on(d, gcfg.name[:-6], mesh)[
        "layers"]["moe"].items()}
    y, aux = L.moe_block(moe, x, n_experts=gcfg.n_experts,
                         top_k=gcfg.experts_top_k, mlp_type=gcfg.mlp_type,
                         capacity_factor=gcfg.capacity_factor,
                         shared_expert=gcfg.shared_expert)
    out["moe"] = (_np(y), float(_np(aux)))
    sh.set_mesh(None)
    return out if torch.distributed.get_rank() == 0 else None


# --------------------------------------------------------------------------
# The JAX side (the subprocess)
# --------------------------------------------------------------------------

def _spec_tuple(spec, ndim):
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if isinstance(e, (tuple, list)) and len(e) == 1:
            e = e[0]
        out.append(tuple(e) if isinstance(e, (tuple, list)) else e)
    return tuple(out)


#: The loss archs each JAX subprocess traces (tracing holds the GIL);
#: part 1 also computes everything else.
JAX_PARTS = (LOSS_ARCHS[:3], LOSS_ARCHS[3:])


def _jax_main(d, part):
    import concurrent.futures

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.checkpoint import pytree_io as jio
    from repro.configs import SHAPES, get_config, smoke
    from repro.distributed import sharding as sh
    from repro.models import layers as JL
    from repro.models import lm as jlm
    from repro.optim import adamw as jadamw
    from repro.train import loop as jloop

    inputs = _inputs(d)
    out = {}

    def mesh(shape):
        n = shape[0] * shape[1]
        return jax.make_mesh(shape, AXES, axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:n])

    def flat(tree):
        return {n: np.asarray(v, np.float32)
                for n, v in jio.flatten_named(tree)[0]}

    meshes = {k: mesh(v) for k, v in MESHES.items()}
    tok, lab = jnp.asarray(inputs["tokens"]), jnp.asarray(inputs["labels"])
    # traced here, each under its policy (the reference's is a thread's),
    # compiled on a pool of threads (XLA's compiler leaves the GIL), run
    lowered = []
    for arch in JAX_PARTS[part]:
        cfg = smoke(get_config(arch))
        params = jax.tree_util.tree_map(jnp.asarray, jio.restore(
            os.path.join(d, f"params-{arch}.scda"))[0])

        def loss_fn(p, cfg=cfg):
            return jlm.lm_loss(cfg, p, tok, lab, loss_chunk=CHUNK,
                               remat=False)
        for key in ("none", "m22", "m41"):
            sh.set_mesh(meshes.get(key))
            placed = params if key == "none" else jax.device_put(
                params, sh.params_shardings(meshes[key], params))
            lowered.append(((key, "loss", arch), placed, jax.jit(
                jax.value_and_grad(loss_fn)).lower(placed)))
            sh.set_mesh(None)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        compiled = list(pool.map(lambda x: x[2].compile(), lowered))
    for (key, placed, _), fn in zip(lowered, compiled):
        loss, grads = fn(placed)
        out[key] = (float(loss), flat(grads))
    if part == 0:
        with open(os.path.join(d, f"jax-{part}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
        return

    # the reference's own host mesh: jax 0.9 makes Explicit axes, which
    # its constrain refuses (the launcher's first step fails so)
    from repro.launch.mesh import make_host_mesh
    host = make_host_mesh(2, 2)
    sh.set_mesh(host)
    try:
        jax.jit(lambda x: sh.constrain(x, "batch", None))(jnp.zeros((4, 2)))
        refused = None
    except Exception as e:  # noqa: BLE001 - its type is the finding
        refused = type(e).__name__
    sh.set_mesh(None)
    out["host_mesh"] = ([str(t) for t in host.axis_types], refused)
    # the spec the reference's constrain hands with_sharding_constraint
    # (an output's sharding drops axes of size 1)
    seen = []
    real = jax.lax.with_sharding_constraint
    jax.lax.with_sharding_constraint = lambda x, s: seen.append(s.spec) or x
    for key, m in meshes.items():
        sh.set_mesh(m)
        for i, (shape, roles) in enumerate(CONSTRAIN_CASES):
            sh.constrain(jnp.zeros(shape), *roles)
            out[(key, "constrain", i)] = _spec_tuple(seen.pop(), len(shape))
        sh.set_mesh(None)
    jax.lax.with_sharding_constraint = real
    for key, m in meshes.items():
        for arch in INPUT_ARCHS:
            for kind, shape_name in (("train", "train_4k"),
                                     ("decode", "decode_32k"),
                                     ("decode", "long_500k")):
                specs = sh.input_shardings(m, kind, get_config(arch),
                                           SHAPES[shape_name])
                out[(key, "inputs", arch, shape_name)] = {
                    k: _spec_tuple(v.spec, len(v.spec))
                    for k, v in specs.items()}

    for arch in SERVE_ARCHS:
        cfg = smoke(get_config(arch))
        params = jax.tree_util.tree_map(jnp.asarray, jio.restore(
            os.path.join(d, f"params-{arch}.scda"))[0])
        for key in ("m22", "m41"):
            sh.set_mesh(meshes[key])
            cache = jlm.init_cache(cfg, B, SERVE_LEN)
            cache.update(k=jnp.asarray(inputs[f"serve_{arch}_k"]),
                         v=jnp.asarray(inputs[f"serve_{arch}_v"]),
                         pos=jnp.asarray(SERVE_POS, jnp.int32))
            step = jax.jit(lambda p, c, t, cfg=cfg: jlm.serve_step(
                cfg, p, c, t))
            logits = []
            for i in range(SERVE_STEPS):
                got, cache = step(params, cache, jnp.asarray(
                    inputs["serve_tokens"][:, i:i + 1]))
                logits.append(np.asarray(got))
            out[(key, "serve", arch)] = (logits, np.asarray(cache["k"]),
                                         int(cache["pos"]))
            sh.set_mesh(None)

    cfg = smoke(get_config(LOSS_ARCHS[0]))
    kw = dict(head_dim=cfg.head_dim_, rope_base=cfg.rope_base)
    gqa = jax.tree_util.tree_map(jnp.asarray, _attn_params(inputs, "gqa"))
    for pos, window in SP_CASES:
        args = (gqa, jnp.asarray(inputs["x_dec"]),
                jnp.asarray(inputs["sp_k"]), jnp.asarray(inputs["sp_v"]),
                jnp.asarray(pos, jnp.int32))

        def dec(p, x, k, v, q, w=window):
            return JL.attention_decode(p, x, k, v, q, n_heads=4, n_kv=2,
                                       window=w, **kw)
        # a fresh function each time: jit's cache does not see the policy
        y, k, v = jax.jit(lambda *a: dec(*a))(*args)
        out[("sp-plain", pos, window)] = (np.asarray(y), np.asarray(k),
                                          np.asarray(v))
        sh.set_mesh(meshes["m41"], sp_decode_axis="data")
        y, k, v = jax.jit(lambda *a: dec(*a))(*args)
        out[("sp", pos, window)] = (np.asarray(y), np.asarray(k),
                                    np.asarray(v))
        sh.set_mesh(None)

    x = jnp.asarray(inputs["x_attn"])
    for name, (H, Hkv) in (("gqa", (4, 2)), ("mha", (4, 4))):
        p = jax.tree_util.tree_map(jnp.asarray, _attn_params(inputs, name))

        def blk(p, x, H=H, Hkv=Hkv):
            return JL.attention_block(p, x, n_heads=H, n_kv=Hkv, **kw)
        out[("none", "attn", name)] = np.asarray(
            jax.jit(lambda *a: blk(*a))(p, x))
        sh.set_mesh(meshes["m13"])
        out[("m13", "attn", name)] = np.asarray(
            jax.jit(lambda *a: blk(*a))(p, x))
        sh.set_mesh(None)
    gcfg = smoke(get_config("granite-moe-3b-a800m"))
    gparams = jio.restore(os.path.join(d, f"params-{gcfg.name[:-6]}.scda"))[0]
    moe = {k: jnp.asarray(v[0]) for k, v in gparams["layers"]["moe"].items()}

    def moe_fn(p, x):
        return JL.moe_block(p, x, n_experts=gcfg.n_experts,
                            top_k=gcfg.experts_top_k, mlp_type=gcfg.mlp_type,
                            capacity_factor=gcfg.capacity_factor,
                            shared_expert=gcfg.shared_expert)
    for key in ("none", "m13"):
        sh.set_mesh(meshes[key] if key != "none" else None)
        y, aux = jax.jit(lambda *a: moe_fn(*a))(moe, x)
        out[(key, "moe")] = (np.asarray(y), float(aux))
    sh.set_mesh(None)

    res = jloop.train(cfg, jloop.TrainLoopConfig(
        total_steps=TRAIN_STEPS, ckpt_every=100,
        ckpt_dir=os.path.join(d, "jax-run"), log_every=100),
        jadamw.AdamWConfig(**TRAIN_LR), seq_len=S, global_batch=B)
    res["manager"].close()
    out["train"] = dict(losses=list(res["losses"]),
                        start=res["start_step"],
                        params=flat(res["state"]["params"]))
    with open(os.path.join(d, f"jax-{part}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


# --------------------------------------------------------------------------
# The runs, once a module
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist-model"))
    _write_inputs(d)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    jax_procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "jax", d, str(part)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for part in range(len(JAX_PARTS))]
    try:
        # the two groups and the launcher's runs side by side: their ranks
        # wait on collectives
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            four = pool.submit(spawn_ranks, _rank4, 4, d, device="cpu")
            three = pool.submit(spawn_ranks, _rank3, 3, d, device="cpu")
            launched = pool.submit(_launcher_runs, os.path.join(d, "launch"),
                                   env)
            port = four.result()[0]
            port.update(three.result()[0])
            launcher = launched.result()
    finally:
        logs = [proc.communicate(timeout=600)[0] for proc in jax_procs]
    ref = {}
    for part, (proc, log) in enumerate(zip(jax_procs, logs)):
        assert proc.returncode == 0, log.decode()[-4000:]
        with open(os.path.join(d, f"jax-{part}.pkl"), "rb") as fh:
            ref.update(pickle.load(fh))
    return dict(port=port, jax=ref, dir=d, launcher=launcher)


def _launcher_runs(ckpt_dir, env):
    """``python -m repro_torch.launch.train`` on CPU ranks: 2 steps on
    ``--data-par 2 --model-par 2`` saving each, then a resume to 3 steps on
    ``--data-par 4 --model-par 1``; their (return code, output)."""
    common = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
              LOSS_ARCHS[0], "--smoke", "--device", "cpu", "--seq-len",
              "16", "--global-batch", "4", "--ckpt-dir", ckpt_dir]
    runs = []
    for extra in (["--steps", "2", "--ckpt-every", "1", "--data-par", "2",
                   "--model-par", "2"],
                  ["--steps", "3", "--data-par", "4", "--model-par", "1"]):
        proc = subprocess.run(common + extra, env=env, capture_output=True,
                              text=True, timeout=300)
        runs.append((proc.returncode, proc.stdout + proc.stderr))
    return runs


# --------------------------------------------------------------------------
# The tests
# --------------------------------------------------------------------------

class _StubMesh:
    """A mesh's names and shape: all the specs' rules read."""

    def __init__(self, shape):
        self.mesh_dim_names = AXES
        self.shape = shape


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", range(len(CONSTRAIN_CASES)))
def test_constrain_spec_is_the_references(runs, mesh, case):
    from repro_torch.distributed import sharding as sh
    shape, roles = CONSTRAIN_CASES[case]
    spec = sh.constrain_spec(_StubMesh(MESHES[mesh]), shape, *roles)
    assert tuple(spec) == runs["jax"][(mesh, "constrain", case)]
    # and the DTensor a rank's constrain made has its placements
    placements = [str(p) for p in sh.placements(_StubMeshPl(mesh), spec)]
    assert runs["port"][(mesh, "constrain", case)] == placements


class _StubMeshPl(_StubMesh):
    def __init__(self, mesh):
        super().__init__(MESHES[mesh])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", INPUT_ARCHS)
@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k",
                                        "long_500k"])
def test_input_shardings_are_the_references(runs, mesh, arch, shape_name):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed import sharding as sh
    kind = SHAPES[shape_name].kind
    kind = "train" if kind == "train" else "decode"
    got = sh.input_shardings(_StubMesh(MESHES[mesh]), kind,
                             get_config(arch), SHAPES[shape_name])
    want = runs["jax"][(mesh, "inputs", arch, shape_name)]
    assert sorted(got) == sorted(want)
    for k, spec in got.items():
        assert _spec_tuple(spec, len(want[k])) == want[k], k


#: The hybrid's gradients against the reference's, relative L2:
#: ``tests/test_torch_hybrid.py``'s GRAD_REL (two f32 evaluations of its
#: Mamba2 layers in another order; A_log's a sum with cancellation).
HYBRID_GRAD_REL = 2e-4


def _hold_loss(got, want, what, hybrid=False):
    loss, grads = got
    wloss, wgrads = want
    np.testing.assert_allclose(loss, wloss, err_msg=f"{what}: loss", **TOL)
    assert sorted(grads) == sorted(wgrads)
    for name, g in grads.items():
        w = wgrads[name]
        if hybrid:
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel <= HYBRID_GRAD_REL, f"{what}: {name}: {rel}"
        else:
            np.testing.assert_allclose(g, w, err_msg=f"{what}: {name}",
                                       **TOL)


@pytest.mark.parametrize("mesh", ["m22", "m41"])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_gradients_equal_the_references_on_the_mesh(runs, mesh,
                                                             arch):
    _hold_loss(runs["port"][(mesh, "loss", arch)],
               runs["jax"][(mesh, "loss", arch)], f"{arch} on {mesh}",
               hybrid=arch == "zamba2-2.7b")


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_padded_heads_and_experts_keep_the_function(runs, arch):
    """(1, 3): 4 q heads in 2 groups pad to 6 (3 a group), 4 experts to 6;
    the loss and every gradient are the no-mesh ones."""
    _hold_loss(runs["port"][("m13", "loss", arch)],
               runs["jax"][("none", "loss", arch)], f"{arch} on (1, 3)",
               hybrid=arch == "zamba2-2.7b")


def test_the_references_padded_gqa_heads_change_the_function(runs):
    """What ROADMAP.md's Queue 3 records: the reference's (1, 3) GQA
    attention is not its no-mesh attention; its MHA attention is."""
    ref = runs["jax"]
    gqa = np.abs(ref[("m13", "attn", "gqa")]
                 - ref[("none", "attn", "gqa")]).max()
    mha = np.abs(ref[("m13", "attn", "mha")]
                 - ref[("none", "attn", "mha")]).max()
    assert gqa > 1e-2 and mha < 1e-5, (gqa, mha)
    print(f"reference (1, 3) vs no mesh, one attention block: GQA 4/2 "
          f"{gqa}, MHA 4/4 {mha}")


def test_the_references_host_mesh_has_explicit_axes(runs):
    """What ROADMAP.md's Queue 3 records: under jax 0.9 the reference's
    ``make_host_mesh`` builds Explicit axes, and its ``constrain`` (a
    with_sharding_constraint) refuses them; the JAX side of these tests
    builds its meshes with Auto axes."""
    axis_types, refused = runs["jax"]["host_mesh"]
    assert all("Explicit" in t for t in axis_types), axis_types
    assert refused is not None


@pytest.mark.parametrize("name", ["gqa", "mha"])
def test_padded_attention_is_exact(runs, name):
    got = runs["port"][("attn", name)]
    np.testing.assert_allclose(got, runs["jax"][("none", "attn", name)],
                               **TOL)
    if name == "mha":   # the reference's layout, which is exact for MHA
        np.testing.assert_allclose(got, runs["jax"][("m13", "attn", name)],
                                   **TOL)


@pytest.mark.parametrize("want", ["none", "m13"])
def test_padded_moe_block_is_exact(runs, want):
    y, aux = runs["port"]["moe"]
    wy, waux = runs["jax"][(want, "moe")]
    np.testing.assert_allclose(y, wy, **TOL)
    np.testing.assert_allclose(aux, waux, **TOL)


@pytest.mark.parametrize("mesh", ["m22", "m41"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_decode_steps_equal_the_references_on_the_mesh(runs, mesh, arch):
    logits, k, pos = runs["port"][(mesh, "serve", arch)]
    wlogits, wk, wpos = runs["jax"][(mesh, "serve", arch)]
    assert pos == wpos == SERVE_POS + SERVE_STEPS
    for i, (g, w) in enumerate(zip(logits, wlogits)):
        np.testing.assert_allclose(g, w, err_msg=f"step {i}", **TOL)
    np.testing.assert_allclose(k, wk, err_msg="cache", **TOL)


@pytest.mark.parametrize("pos,window", SP_CASES)
def test_sp_decode_equals_the_references_and_the_plain_decode(runs, pos,
                                                              window):
    got = runs["port"][("sp", pos, window)]
    for want in ("sp", "sp-plain"):
        ref = runs["jax"][(want, pos, window)]
        for a, b, what in zip(got, ref, ("out", "cache_k", "cache_v")):
            np.testing.assert_allclose(a, b, err_msg=f"{want}: {what}",
                                       **TOL)


def test_training_on_two_meshes_reproduces_the_single_device_run(runs):
    """Steps 1-3 under (2, 2), killed after the step-3 save, steps 4-5
    resumed under (4, 1): the losses are the JAX package's single-device
    loop's from the same checkpoint 0, and so are the final parameters,
    restored here from the port's last file without a mesh."""
    from repro_torch.checkpoint import restore
    got, want = runs["port"]["train"], runs["jax"]["train"]
    assert got["start"] == TRAIN_SAVE and want["start"] == 0
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    path = os.path.join(runs["dir"], "port-run",
                        f"step_{TRAIN_STEPS - 1:010d}.scda")
    state = restore(path)[0]
    params = {n: np.asarray(t, np.float32)
              for n, t in _names(state["params"])}
    assert sorted(params) == sorted(want["params"])
    for name, p in params.items():
        np.testing.assert_allclose(p, want["params"][name], err_msg=name,
                                   **TOL)


def test_launcher_trains_on_a_mesh_and_resumes_on_another(runs):
    (rc1, first), (rc2, second) = runs["launcher"]
    assert rc1 == 0, first[-3000:]
    assert "done: start_step=-1" in first and "checkpoints=[1]" in first
    assert rc2 == 0, second[-3000:]
    assert "done: start_step=1" in second and "checkpoints=[1, 2]" in second


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    _jax_main(sys.argv[2], int(sys.argv[3]))
