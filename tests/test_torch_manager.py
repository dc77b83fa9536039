"""The port's CheckpointManager against the JAX package's: byte-identical
flat saves, directories written by both managers in turn, retention, the
writer lock, fallback past a corrupted newest file, restore-or-init, the
journal, compressed saves, a snapshot that in-place updates cannot reach,
a power-cut replay of the port's commit (``tests/helpers/crashsim.py``
rebound to the port's fault layer), and the sharded, parity and delta
layouts: sets byte-identical to the reference manager's, delta chains and
their cap, chain-aware retention that drops sets whole, the environment
knobs, a restore through a lost shard, and the trace records of a set's
save against the reference's."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import pytree_io as jio  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.core import trace as jtrace  # noqa: E402
from repro.journal import read_records  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch.checkpoint import pytree_io as tio  # noqa: E402
from repro_torch.checkpoint import sharding as tsh  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.pytree_io import REFERENCE_VENDOR  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import ScdaError  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import trace as ttrace  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import crashsim  # noqa: E402


@pytest.fixture(autouse=True)
def _flat_saves(monkeypatch):
    """The reference's managers default to the environment's layout; the
    comparisons here are of flat, full saves."""
    for name in ("REPRO_SCDA_SHARDS", "REPRO_SCDA_PARITY",
                 "REPRO_SCDA_DELTA", "REPRO_SCDA_DELTA_CHAIN",
                 "REPRO_SCDA_FAULTS"):
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


# ------------------------------------------- sets, parity and deltas --
CB = 1 << 12   # 4 KiB chunks: one edit dirties one chunk


def _bump(state, k: int):
    """The state after a sparse update: one element of ``params/w`` and
    the count change (as a step that touches little would)."""
    out = jax.tree_util.tree_map(lambda t: t.clone(), state)
    out["params"]["w"][k % 17, k % 5] += 1.0
    out["opt"] = out["opt"]._replace(count=out["opt"].count + 1)
    return out


def _jbump(state, k: int):
    arrays = jax.tree_util.tree_map(np.asarray, state)
    w = arrays["params"]["w"].copy()
    w[k % 17, k % 5] += 1.0
    params = dict(arrays["params"], w=jnp.asarray(w))
    return {"params": params, "opt": arrays["opt"]._replace(
        count=jnp.asarray(arrays["opt"].count + 1))}


@pytest.mark.parametrize("layout", [dict(shards=2, parity=1),
                                    dict(shards=4, parity=2, delta=True),
                                    dict(shards=0, delta=True)])
def test_set_and_delta_saves_are_byte_identical_to_jax(tmp_path, layout):
    """Three steps (a full save, then deltas where asked): every file the
    two managers leave, sidecars included, is the same."""
    jstate, tstate = _jstate(3), _tstate(3)
    with JManager(str(tmp_path / "j"), keep=2, chunk_bytes=CB,
                  **layout) as mgr:
        for step in (1, 2, 3):
            mgr.save(step, jstate, blocking=True)
            jstate = _jbump(jstate, step)
    with CheckpointManager(str(tmp_path / "t"), keep=2, chunk_bytes=CB,
                           vendor=REFERENCE_VENDOR, **layout) as mgr:
        for step in (1, 2, 3):
            mgr.save(step, tstate, blocking=True)
            tstate = _bump(tstate, step)
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    for f in names:
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f


def test_delta_chain_and_its_cap(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCDA_DELTA", "1")
    monkeypatch.setenv("REPRO_SCDA_DELTA_CHAIN", "2")
    states = [_tstate(1)]
    with CheckpointManager(str(tmp_path), keep=10, chunk_bytes=CB) as mgr:
        assert mgr.delta and mgr.delta_chain == 2
        for step in range(5):
            mgr.save(step, states[-1], blocking=True)
            states.append(_bump(states[-1], step))
        docs = [tio.read_manifest(mgr.path_for(k)) for k in range(5)]
        assert [(d.get("delta") or {}).get("depth", 0) for d in docs] == \
            [0, 1, 2, 0, 1]
        assert docs[3]["version"] == 1 and docs[3]["leaves"][0]["chunks"]
        for step in range(5):
            got, s = mgr.restore(step, _like())
            assert s == step
            _assert_same(got, states[step], f"step {step}")


def test_retention_keeps_a_referenced_base(tmp_path):
    """keep=1 with a sharded delta chain: the newest step's shards still
    reference the first set, so it stays, whole, with its parity."""
    states = [_tstate(2)]
    with CheckpointManager(str(tmp_path), keep=1, shards=2, parity=1,
                           delta=True, chunk_bytes=CB) as mgr:
        for step in (3, 5):
            mgr.save(step, states[-1], blocking=True)
            states.append(_bump(states[-1], step))
        assert mgr.all_steps() == [3, 5]
        doc = tsh.load_set(mgr.path_for(5))
        bases = {b["file"] for sd in doc["shard_docs"]
                 for b in (sd.get("delta") or {}).get("bases", [])}
        assert bases and all(b.startswith("step_0000000003-s")
                             for b in bases)
        names = set(os.listdir(tmp_path))
        for f in ("step_0000000003-s00of02.scda",
                  "step_0000000003-s01of02.scda",
                  "step_0000000003-p00of01.scda"):
            assert f in names and f + ".scdax" in names
        got, step = mgr.restore_latest(_like())
    assert step == 5
    _assert_same(got, states[1])


def test_retention_drops_whole_sets_and_sweeps_orphans(tmp_path):
    with CheckpointManager(str(tmp_path), keep=2, shards=2,
                           parity=2) as mgr:
        mgr.save(1, _tstate(1), blocking=True)
        orphan = str(tmp_path / "step_0000000099-s00of02.scda")
        tio.save(orphan, _tstate(9), step=99)
        orphan_parity = str(tmp_path / "step_0000000098-p01of02.scda")
        (tmp_path / "step_0000000098-p01of02.scda").write_bytes(b"x")
        for step in (2, 3, 4):
            mgr.save(step, _tstate(step), blocking=True)
        assert mgr.all_steps() == [3, 4]
    names = sorted(n for n in os.listdir(tmp_path) if n != ".scda-lock")
    assert not os.path.exists(orphan) and not os.path.exists(orphan_parity)
    want = []
    for step in (3, 4):
        stem = f"step_{step:010d}"
        for f in (f"{stem}-p00of02.scda", f"{stem}-p01of02.scda",
                  f"{stem}-s00of02.scda", f"{stem}-s01of02.scda",
                  f"{stem}.scda"):
            want += [f, f + ".scdax"]
    assert names == sorted(want)


def test_knobs_select_the_layout(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCDA_SHARDS", "3")
    monkeypatch.setenv("REPRO_SCDA_PARITY", "2")
    monkeypatch.setenv("REPRO_SCDA_DELTA", "1")
    with CheckpointManager(str(tmp_path)) as mgr:
        assert (mgr.shards, mgr.parity, mgr.delta) == (3, 2, True)
        mgr.save(1, _tstate(1), blocking=True)
        mgr.save(2, _bump(_tstate(1), 1), blocking=True)
        doc = tsh.load_set(mgr.path_for(2))
    assert len(doc["shards"]) == 3 and doc["parity"]["m"] == 2
    assert tsh.chain_depth(doc) == 1
    monkeypatch.setenv("REPRO_SCDA_SHARDS", "0")
    with CheckpointManager(str(tmp_path / "flat")) as mgr:
        assert (mgr.shards, mgr.parity) == (0, 0)
    monkeypatch.setenv("REPRO_SCDA_SHARDS", "2")
    monkeypatch.setenv("REPRO_SCDA_PARITY", "3")
    with pytest.raises(ScdaError):
        CheckpointManager(str(tmp_path / "bad"))


@pytest.mark.parametrize("lost", ["data", "two data"])
def test_restore_latest_through_lost_shards(tmp_path, lost):
    """The newest set lost shards within its parity: restore_latest
    reconstructs them (no fallback to the older step), and a delta saved
    next takes the older set as its base, as the newest cannot be opened
    whole (the reference's choice)."""
    d = str(tmp_path / "c")
    with CheckpointManager(d, keep=3, shards=3, parity=2,
                           delta=True) as mgr:
        mgr.save(1, _tstate(1), blocking=True)
        mgr.save(2, _tstate(2), blocking=True)
        for k in range(1 if lost == "data" else 2):
            os.remove(tsh.shard_file(mgr.path_for(2), k, 3))
    with CheckpointManager(d, keep=3, shards=3, parity=2,
                           delta=True) as mgr:
        got, step = mgr.restore_latest(_like(), device="cpu")
        assert step == 2
        _assert_same(got, _tstate(2))
        mgr.save(3, _tstate(3), blocking=True)
        doc = tsh.load_set(mgr.path_for(3))
        assert tsh.chain_depth(doc) == 1
        assert {b["file"][:16] for sd in doc["shard_docs"]
                for b in sd["delta"]["bases"]} == {"step_0000000001-"}
        got, _ = mgr.restore(3, _like())
        _assert_same(got, _tstate(3))


def _ckpt_events(trace_mod, path):
    """The ckpt-category records of a trace, in order: name and args,
    each path by its base name."""
    out = []
    for ev in trace_mod.load_chrome(path):
        if ev["cat"] != "ckpt":
            continue
        args = {k: (os.path.basename(v) if k == "path" else v)
                for k, v in (ev.get("args") or {}).items()}
        out.append((ev["name"], args))
    return out


def test_set_save_emits_the_references_trace_records(tmp_path):
    """A set saved by ``save`` and by the manager (with a delta) emits the
    reference's span and event names and arguments in the same order;
    the port's manager adds only its ``snapshot`` span (the pinned host
    copy, which the reference does not take)."""
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()

    def run(trace_mod, save_fn, manager, state, bump, d):
        path = str(d / "trace.json")
        tc = trace_mod.install(trace_mod.TraceCollector(path=path))
        try:
            save_fn(str(d / "set.scda"), state)
            with manager(str(d / "m"), keep=1, shards=3, parity=2,
                         delta=True, chunk_bytes=CB) as mgr:
                mgr.save(1, state, blocking=True)
                mgr.save(2, bump(state, 1), blocking=True)
        finally:
            trace_mod.uninstall()
        tc.export()
        return _ckpt_events(trace_mod, path)

    jev = run(jtrace, lambda p, s: jio.save(p, s, step=1, shards=3, parity=2),
              JManager, _jstate(4), _jbump, jdir)
    tev = run(ttrace, lambda p, s: tio.save(p, s, step=1, shards=3, parity=2,
                                            vendor=REFERENCE_VENDOR),
              lambda *a, **k: CheckpointManager(*a, vendor=REFERENCE_VENDOR,
                                                **k),
              _tstate(4), _bump, tdir)
    assert [e for e in tev if e[0] != "snapshot"] == jev
    assert [e[0] for e in tev].count("snapshot") == 2
    names = {e[0] for e in jev}
    assert {"save", "plan", "write_archive", "shard_placement", "commit",
            "parity_encode", "retention"} <= names
