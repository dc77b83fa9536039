"""The port's training loop against the JAX package's, on the CPU: torch
mirrors of ``tests/test_system.py::TestTrainLoop``, a run started in
either package and resumed in the other, and the launcher."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.configs import get_config, smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import loop as jloop  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import smoke as tsmoke  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402

#: The dense, the Mamba1 (ssm), the hybrid and the moe family: the loop
#: runs for each.
ARCHS = ("qwen3-1.7b", "falcon-mamba-7b", "zamba2-2.7b", "gemma3-4b",
         "granite-moe-3b-a800m")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke model's ops are tiny: one thread is several times faster
    than a pool shared with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------- loop --
def _loop(path, steps, **kw):
    return dict(total_steps=steps, ckpt_every=4, ckpt_dir=str(path),
                log_every=100, **kw)


def _train(path, steps, opt=None, hooks=None, arch=ARCHS[0], **kw):
    cfg = tsmoke(tget(arch))
    opt = opt or tadamw.AdamWConfig(total_steps=steps)
    return tloop.train(cfg, tloop.TrainLoopConfig(**_loop(path, steps, **kw)),
                       opt, seq_len=32, global_batch=4, hooks=hooks,
                       device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_decreases(tmp_path, arch):
    out = _train(tmp_path / "c", 12,
                 tadamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=12),
                 arch=arch)
    assert out["losses"][-1] < out["losses"][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_restart_resumes_and_matches(tmp_path, arch):
    """Die at step 6, restart, finish: the state continues (not reset)."""
    with pytest.raises(SystemExit):
        _train(tmp_path / "c", 12, hooks={"should_die": lambda s: s == 6},
               arch=arch)
    out = _train(tmp_path / "c", 12, arch=arch)
    assert out["start_step"] == 4
    ref = _train(tmp_path / "ref", 12, arch=arch)
    assert abs(out["losses"][-1] - ref["losses"][-1]) < 0.05


def test_grad_compress_trains(tmp_path):
    out = _train(tmp_path / "c", 8,
                 tadamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=8),
                 grad_compress=True)
    assert np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0] + 0.1


def test_compressed_checkpoints_resume(tmp_path):
    out = _train(tmp_path / "c", 6, ckpt_compressed=True)
    assert out["manager"].all_steps()
    out["manager"].close()
    assert _train(tmp_path / "c", 6, ckpt_compressed=True)["start_step"] == 5


# ------------------------------------------------- cross-package resume --
def _seed_step0(directory, arch):
    """The JAX package's initial training state as checkpoint 0, so both
    packages' runs start from the same weights."""
    cfg = smoke(get_config(arch))
    params = jlm.init_lm(cfg, jax.random.PRNGKey(0))
    with JManager(str(directory), shards=0, delta=False) as mgr:
        mgr.save(0, {"params": params, "opt": jadamw.init(params)},
                 blocking=True)


def _jax_train(path, steps, hooks=None, arch=ARCHS[0]):
    return jloop.train(smoke(get_config(arch)),
                       jloop.TrainLoopConfig(**_loop(path, steps)),
                       jadamw.AdamWConfig(total_steps=steps), seq_len=32,
                       global_batch=4, hooks=hooks)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("first", ["jax", "torch"])
def test_a_run_resumes_in_the_other_package(tmp_path, first, arch,
                                            monkeypatch):
    """A run started (from a shared step-0 state) and killed at step 6 in
    one package resumes from its step-4 checkpoint in the other; the
    resumed losses are within 1e-4 of an uninterrupted run in the
    resuming package."""
    monkeypatch.setenv("REPRO_SCDA_SHARDS", "0")
    monkeypatch.setenv("REPRO_SCDA_DELTA", "0")
    run, ref = tmp_path / "run", tmp_path / "ref"
    for d in (run, ref):
        _seed_step0(d, arch)
    starts = {"jax": _jax_train, "torch": _train}
    resumes = {"jax": _jax_train, "torch": _train}
    second = "torch" if first == "jax" else "jax"
    with pytest.raises(SystemExit):
        starts[first](run, 10, hooks={"should_die": lambda s: s == 6},
                      arch=arch)
    got = resumes[second](run, 10, arch=arch)
    want = resumes[second](ref, 10, arch=arch)
    assert got["start_step"] == 4 and want["start_step"] == 0
    np.testing.assert_allclose(got["losses"], want["losses"][4:], rtol=0,
                               atol=1e-4)


# -------------------------------------------------------------- launcher --
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_on_the_cpu(tmp_path, capsys, arch):
    from repro_torch.launch import train as launch
    launch.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                 "3", "--seq-len", "16", "--global-batch", "2",
                 "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "done: start_step=-1" in out and "checkpoints=[2]" in out
    assert os.listdir(tmp_path / f"{arch}-smoke")


def test_launcher_refuses_a_mesh(tmp_path):
    """A mesh with no model axis is refused before any rank starts (the
    launcher trains under a (data, model) mesh since the distributed
    slice: tests/test_torch_dist_model.py runs one)."""
    from repro_torch.launch import train as launch
    with pytest.raises(SystemExit):
        launch.main(["--arch", ARCHS[0], "--device", "cpu", "--data-par", "2",
                     "--model-par", "0", "--ckpt-dir", str(tmp_path)])
