"""The port's CheckpointManager against the JAX package's: byte-identical
flat saves, directories written by both managers in turn, retention, the
writer lock, fallback past a corrupted newest file, restore-or-init, the
journal, compressed saves, a snapshot that in-place updates cannot reach,
and a power-cut replay of the port's commit (``tests/helpers/crashsim.py``
rebound to the port's fault layer)."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.journal import read_records  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.pytree_io import REFERENCE_VENDOR  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import ScdaError  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import crashsim  # noqa: E402


@pytest.fixture(autouse=True)
def _flat_saves(monkeypatch):
    """The reference's managers default to the environment's layout; the
    comparisons here are of flat, full saves."""
    for name in ("REPRO_SCDA_SHARDS", "REPRO_SCDA_PARITY",
                 "REPRO_SCDA_DELTA", "REPRO_SCDA_FAULTS"):
        monkeypatch.delenv(name, raising=False)


def _jstate(seed: int):
    """A training state in the JAX package: f32 and bf16 leaves and an
    AdamWState with its 0-d int32 count."""
    rng = np.random.default_rng(seed)
    params = {"w": jnp.asarray(rng.standard_normal((17, 5)), jnp.float32),
              "h": jnp.asarray(rng.standard_normal((4, 3)), jnp.bfloat16)}
    opt = jadamw.init(params)._replace(count=jnp.asarray(seed, jnp.int32))
    return {"params": params, "opt": opt}


def _tstate(seed: int):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                    _jstate(seed)), "cpu")


def _like():
    return {"params": {"w": torch.empty(17, 5, device="meta"),
                       "h": torch.empty(4, 3, dtype=torch.bfloat16,
                                        device="meta")},
            "opt": tadamw.AdamWState(
                mu={"h": torch.empty(4, 3, device="meta"),
                    "w": torch.empty(17, 5, device="meta")},
                nu={"h": torch.empty(4, 3, device="meta"),
                    "w": torch.empty(17, 5, device="meta")},
                count=torch.empty((), dtype=torch.int32, device="meta"))}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{prefix}{k}/")]
    if isinstance(tree, tuple):
        return [x for f in tree._fields
                for x in _leaves(getattr(tree, f), f"{prefix}{f}/")]
    return [(prefix[:-1], tree)]


def _bits(x) -> np.ndarray:
    """A leaf's bytes, from either package."""
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _assert_same(got, want, what=""):
    g, w = _leaves(got), _leaves(want)
    assert [n for n, _ in g] == [n for n, _ in w], what
    for (name, a), (_, b) in zip(g, w):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"{what} "
                                      f"{name}")


@pytest.mark.parametrize("compressed", [False, True])
def test_flat_save_is_byte_identical_to_jax(tmp_path, compressed):
    with JManager(str(tmp_path / "j"), compressed=compressed) as mgr:
        mgr.save(3, _jstate(3), blocking=True)
    with CheckpointManager(str(tmp_path / "t"), compressed=compressed,
                           vendor=REFERENCE_VENDOR) as mgr:
        mgr.save(3, _tstate(3), blocking=True)
    name = "step_0000000003.scda"
    for f in (name, name + ".scdax"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f


def test_managers_restore_each_others_checkpoints(tmp_path):
    """One directory written by both managers in turn; each restores the
    other's checkpoints (and its own), NamedTuple and 0-d count included."""
    d = str(tmp_path / "c")
    for step in (1, 2, 3, 4):
        if step % 2:
            with JManager(d, keep=4) as mgr:
                mgr.save(step, _jstate(step), blocking=True)
        else:
            with CheckpointManager(d, keep=4) as mgr:
                mgr.save(step, _tstate(step), blocking=True)
    jlike = jax.eval_shape(lambda: _jstate(0))
    with JManager(d, keep=4) as jm, CheckpointManager(d, keep=4) as tm:
        assert jm.all_steps() == tm.all_steps() == [1, 2, 3, 4]
        for step in (1, 2, 3, 4):
            got, s = tm.restore(step, _like())
            assert s == step and isinstance(got["opt"], tadamw.AdamWState)
            assert got["opt"].count.dim() == 0
            _assert_same(got, _tstate(step), f"port restores {step}")
            got, s = jm.restore(step, jlike)
            assert s == step
            _assert_same(got, _jstate(step), f"jax restores {step}")


def test_retention_keeps_the_newest(tmp_path):
    d = tmp_path / "c"
    with CheckpointManager(str(d), keep=2) as mgr:
        for step in range(1, 6):
            mgr.save(step, _tstate(step))
        mgr.wait()
        assert mgr.all_steps() == [4, 5]
    assert sorted(os.listdir(d)) == [".scda-lock"] * 0 + [
        "step_0000000004.scda", "step_0000000004.scda.scdax",
        "step_0000000005.scda", "step_0000000005.scda.scdax"]


def test_lock_refuses_a_live_holder(tmp_path):
    import json
    import socket
    d = tmp_path / "c"
    d.mkdir()
    (d / ".scda-lock").write_text(json.dumps(
        {"pid": os.getppid(), "host": socket.gethostname(), "time": 0}))
    with pytest.raises(ScdaError, match="locked"):
        CheckpointManager(str(d))


def test_lock_is_taken_over_from_a_dead_holder(tmp_path):
    import json
    import socket
    import subprocess
    proc = subprocess.Popen(["true"])
    proc.wait()
    d = tmp_path / "c"
    d.mkdir()
    (d / ".scda-lock").write_text(json.dumps(
        {"pid": proc.pid, "host": socket.gethostname(), "time": 0}))
    with CheckpointManager(str(d)) as mgr:
        mgr.save(1, _tstate(1), blocking=True)
    assert not (d / ".scda-lock").exists()


def test_restore_latest_falls_back_past_a_truncated_file(tmp_path):
    d = str(tmp_path / "c")
    with CheckpointManager(d, keep=3) as mgr:
        mgr.save(1, _tstate(1), blocking=True)
        mgr.save(2, _tstate(2), blocking=True)
        path = mgr.path_for(2)
        os.truncate(path, os.path.getsize(path) // 2)
        os.remove(path + ".scdax")
        got, step = mgr.restore_latest(_like())
    assert step == 1
    _assert_same(got, _tstate(1))


def test_restore_or_init_builds_nothing_when_a_checkpoint_exists(tmp_path):
    d = str(tmp_path / "c")
    with CheckpointManager(d) as mgr:
        state, step = mgr.restore_or_init(lambda: _tstate(7), _like())
        assert step == -1
        _assert_same(state, _tstate(7))
        mgr.save(7, state, blocking=True)

    def init():
        raise AssertionError("init_fn ran although a checkpoint exists")
    with CheckpointManager(d) as mgr:
        state, step = mgr.restore_or_init(init, _like(), device="cpu")
    assert step == 7
    _assert_same(state, _tstate(7))


def test_journal_flushes_on_commit(tmp_path):
    d = str(tmp_path / "c")
    with CheckpointManager(d) as mgr:
        mgr.journal().log(0, {"loss": 2.5, "lr": 1e-3})
        mgr.save(1, _tstate(1))
        mgr.wait()  # step 1 committed: its records went into its file
        mgr.journal().log(1, {"loss": torch.tensor(2.0).item()})
        mgr.save(2, _tstate(2), blocking=True)
        first, second = mgr.path_for(1), mgr.path_for(2)
    recs = read_records(first)
    assert [(r["step"], r["data"]) for r in recs] == \
        [(0, {"loss": 2.5, "lr": 1e-3})]
    assert [(r["step"], r["data"]) for r in read_records(second)] == \
        [(1, {"loss": 2.0})]


def test_snapshot_is_not_reached_by_in_place_updates(tmp_path):
    """save() returns after the snapshot; an update in place right after
    it (the optimizer's) does not reach the file being written."""
    state = _tstate(5)
    with CheckpointManager(str(tmp_path / "c")) as mgr:
        mgr.save(5, state)
        for _, leaf in _leaves(state):
            leaf.add_(1)
        mgr.wait()
        got, _ = mgr.restore(5, _like())
    _assert_same(got, _tstate(5))


def test_unported_layouts_raise(tmp_path, monkeypatch):
    for kw in (dict(delta=True), dict(shards=2), dict(parity=1)):
        with pytest.raises(NotImplementedError):
            CheckpointManager(str(tmp_path / "c"), **kw)
    monkeypatch.setenv("REPRO_SCDA_DELTA", "1")
    with pytest.raises(NotImplementedError):
        CheckpointManager(str(tmp_path / "c"))


def test_powercut_replay_of_a_port_commit(tmp_path, monkeypatch):
    """Every sampled crash prefix of a port manager's commit restores the
    previous checkpoint or the complete new one; the complete op log
    restores the new one under every volatile choice."""
    monkeypatch.setattr(crashsim, "faults", tfaults)
    monkeypatch.setattr(crashsim, "Op", tfaults.Op)
    monkeypatch.setenv("REPRO_SCDA_WRITE_PIPELINE", "0")
    d = str(tmp_path / "c")
    mgr = CheckpointManager(d, keep=4)
    mgr.save(1, _tstate(1), blocking=True)
    rec = crashsim.record_commit(
        d, lambda: mgr.save(2, _tstate(2), blocking=True))
    assert len(rec.ops) > 0 and any(o.op == "fsync_dir" for o in rec.ops)
    try:
        for k, variant, files in crashsim.iter_crash_states(
                rec, seed=11, prefixes=crashsim.sampled_prefixes(
                    rec, 14, seed=7), variants=1):
            crashsim.materialize(d, files)
            got, step = CheckpointManager(d, keep=4).restore_latest(_like())
            assert step in (1, 2), f"prefix {k}: step {step}"
            _assert_same(got, _tstate(step), f"prefix {k} variant {variant}")
            if k == len(rec.ops):
                assert step == 2, f"complete commit rolled back to {step}"
    finally:
        crashsim.materialize(d, rec.final)
