"""The frozen counts against the worked figures of PERF.md (§2, §4, §6) and
against the port's own parameter tree."""
import dataclasses
import json
import statistics

import pytest

from perfbench.counts import kernels as kc
from perfbench.counts import model as mc
from perfbench.drivers.prefill import lengths
from perfbench.lib import cell as cell_mod

CONFIGS = {n: json.loads((cell_mod.PERFBENCH / "configs" / f"{n}.json")
                         .read_text())["run"]
           for n in ("falcon-mamba-7b",)}


def at(name, layers):
    return dict(CONFIGS[name], n_layers=layers)


def test_falcon_at_2_layers_is_perf_mds_figure_with_the_norms():
    """PERF.md §4's 476,938,240 is the port's ``param_count()``, which
    leaves out each layer's norm and conv bias and the final norm."""
    run = at("falcon-mamba-7b", 2)
    left_out = 2 * (run["d_model"] + run["d_inner"]) + run["d_model"]
    assert mc.param_count(run) - left_out == 476_938_240


def test_falcon_at_8_layers():
    run = at("falcon-mamba-7b", 8)
    left_out = 8 * (run["d_model"] + run["d_inner"]) + run["d_model"]
    assert mc.param_count(run) - left_out == 1_108_738_048
    assert mc.train_flops_per_token(run, 4096) == 6 * mc.param_count(run)


def test_prefill_flops_are_the_layers_and_the_head():
    run = at("falcon-mamba-7b", 8)
    head = 2 * 4096 * 65024
    assert mc.prefill_flops(run, 4096) == \
        2 * (mc.param_count(run) - 65024 * 4096 - 4096) * 4096 + head


@pytest.mark.parametrize("name,layers", [("falcon-mamba-7b", 2),
                                         ("falcon-mamba-7b", 8)])
def test_shapes_are_the_ports(name, layers):
    from repro_torch.checkpoint.pytree_io import flatten_named
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    cfg = dataclasses.replace(get_config(name), n_layers=layers)
    named, _ = flatten_named(init_lm(cfg, device="meta"))
    port = {n.replace("/", "."): tuple(t.shape) for n, t in named}
    ours = {n: s for n, (s, _) in mc.leaf_specs(at(name, layers)).items()}
    assert port == ours


def test_kernel_bounds_are_perf_mds():
    """PERF.md §6's bounds (ms): the fused K2 at 4 x 512, d 8192, N 16,
    0.06419; K2's backward at 8 x 1024, 0.32115."""
    assert kc.k2_fused_s(4, 512, 8192, 16, states=False) * 1e3 == \
        pytest.approx(0.06419, abs=5e-6)
    assert kc.k2_bwd_s(8, 1024, 8192, 16) * 1e3 == \
        pytest.approx(0.32115, abs=5e-6)


def test_prefill_mix():
    mix = json.loads((cell_mod.PERFBENCH / "traffic" / "prefill_32k.json")
                     .read_text())
    got = lengths(mix["lengths"])
    assert got == [4096, 5120, 5120, 6144, 7168, 8192, 9216, 11264, 12288,
                   14336, 16384, 18432, 21504, 24576, 28672, 32768]
    assert statistics.mean(got) == 14_080
