"""The port's public surface against the reference's: every public
function and class of each module of ``src/repro/`` that has a
counterpart in ``src/repro_torch/`` (the same path) exists there, and
takes at least the reference's parameters (by name; a class's
``__init__`` and public methods each).  ``EXCEPTIONS`` lists what the
port leaves out, each with its reason, and is itself held: every entry
must still name a real difference."""
import importlib
import inspect
import os
import pathlib

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

os.environ.setdefault("JAX_PLATFORMS", "cpu")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

#: ``module.name`` (or ``module.name(param)``) → why the port lacks it.
EXCEPTIONS = {
    "core.comm.JaxProcessComm":
        "JAX's multi-process runtime; the port's is TorchDistComm",
    "launch.dryrun.compile_cell":
        "lowers and compiles a cell to HLO; PyTorch has no HLO — the "
        "port traces the step on meta tensors (trace_cell)",
    "kernels.ops.default_backend_is_tpu":
        "asks JAX for its default backend; the port dispatches on the "
        "tensor's device",
    "checkpoint.pytree_io.leaf_name":
        "turns a jax.tree_util key path into a name; the port names its "
        "leaves with flatten_named",
    "launch.specs.hybrid_kv_shape_fix":
        "an identity on JAX shardings; the port's specs need no fix",
    "kernels.flash_attention.flash_attention_kernel":
        "the Pallas entry point (block_q, block_k, interpret are Pallas "
        "knobs); its Hopper counterpart is flash_attention_cuda",
    "kernels.ssm_scan.ssm_scan_kernel":
        "the Pallas entry point (chunk, d_block, interpret are Pallas "
        "knobs); its Hopper counterpart is ssm_scan_cuda",
    "models.lm.lm_loss(kw)":
        "the reference forwards **kw to forward_hidden; the port spells "
        "each of them out",
}
#: ``init_*`` take a seed where the reference takes a PRNG ``key``.
INIT_KEY = "key"


def _modules(root: pathlib.Path):
    out = set()
    for p in root.rglob("*.py"):
        rel = p.relative_to(root).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        if parts:
            out.add(".".join(parts))
    return out


PORTED = sorted(_modules(SRC / "repro") & _modules(SRC / "repro_torch"))


def _public(mod):
    for attr, obj in sorted(vars(mod).items()):
        if attr.startswith("_"):
            continue
        if (inspect.isfunction(obj) or inspect.isclass(obj)) and \
                getattr(obj, "__module__", None) == mod.__name__:
            yield attr, obj


def _callables(attr, obj, pobj):
    """``(qualified name, reference callable, port callable or None)``."""
    if not inspect.isclass(obj):
        return [(attr, obj, pobj)]
    out = []
    for meth, f in vars(obj).items():
        if meth.startswith("_") and meth != "__init__":
            continue
        if not (callable(f) or isinstance(f, (staticmethod, classmethod))):
            continue
        out.append((f"{attr}.{meth}", getattr(obj, meth),
                    getattr(pobj, meth, None)))
    return out


def _differences(name):
    """Every public name or parameter of module ``name`` the port
    lacks, as ``module.name`` or ``module.name(param)``."""
    ref = importlib.import_module("repro." + name)
    port = importlib.import_module("repro_torch." + name)
    out = []
    for attr, obj in _public(ref):
        if not hasattr(port, attr):
            out.append(f"{name}.{attr}")
            continue
        for qual, rf, pf in _callables(attr, obj, getattr(port, attr)):
            if pf is None:
                out.append(f"{name}.{qual}")
                continue
            try:
                rp = inspect.signature(rf).parameters
                pp = inspect.signature(pf).parameters
            except (TypeError, ValueError):
                continue
            var_kw = any(p.kind == p.VAR_KEYWORD for p in pp.values())
            for p, param in rp.items():
                if p in pp:
                    continue
                if param.kind == param.VAR_POSITIONAL:
                    continue
                if param.kind == param.VAR_KEYWORD and var_kw:
                    continue
                if p == INIT_KEY and qual.startswith("init_"):
                    continue
                out.append(f"{name}.{qual}({p})")
    return out


@pytest.mark.parametrize("name", PORTED)
def test_the_port_takes_the_references_parameters(name):
    bad = [d for d in _differences(name) if d not in EXCEPTIONS]
    assert not bad, bad


def test_every_exception_names_a_real_difference():
    found = {d for name in PORTED for d in _differences(name)}
    assert set(EXCEPTIONS) <= found, set(EXCEPTIONS) - found


def test_init_functions_take_a_seed_where_the_reference_takes_a_key():
    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm
    assert "key" in inspect.signature(jlm.init_lm).parameters
    assert "seed" in inspect.signature(tlm.init_lm).parameters


def test_lm_loss_spells_out_what_the_reference_forwards():
    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm
    fwd = inspect.signature(jlm.forward_hidden).parameters
    port = inspect.signature(tlm.lm_loss).parameters
    forwarded = [p for p in fwd if p not in ("cfg", "params", "tokens")]
    assert forwarded and all(p in port for p in forwarded)


@pytest.mark.parametrize("ref,port", [
    ("kernels.flash_attention.flash_attention_kernel",
     "kernels.flash_attention.flash_attention_cuda"),
    ("kernels.ssm_scan.ssm_scan_kernel", "kernels.ssm_scan.ssm_scan_cuda")])
def test_the_pallas_entry_points_have_hopper_counterparts(ref, port):
    rmod, rname = ref.rsplit(".", 1)
    pmod, pname = port.rsplit(".", 1)
    rf = getattr(importlib.import_module("repro." + rmod), rname)
    pf = getattr(importlib.import_module("repro_torch." + pmod), pname)
    pallas = {"block_q", "block_k", "chunk", "d_block", "interpret"}
    want = [p for p in inspect.signature(rf).parameters if p not in pallas]
    have = inspect.signature(pf.__call__).parameters
    assert all(p in have for p in want), (want, list(have))
