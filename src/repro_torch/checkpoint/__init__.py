"""Checkpoint/restart of torch state on the scda format: flat archives,
sharded sets with parity shards, and delta chains.

    from repro_torch.checkpoint import CheckpointManager, save, restore

    save("/ckpts/w.scda", params, step=1000, shards=4, parity=2)
    params, step = restore("/ckpts/w.scda", like=params, device="cuda")

    mgr = CheckpointManager("/ckpts/run7", keep=3)
    state, start = mgr.restore_or_init(init_fn, like=state_like)
    mgr.save(step, state)          # async, atomic, serial-equivalent
"""
from repro_torch.checkpoint.delta import (checkpoint_diff, squash,
                                          verify_chain)
from repro_torch.checkpoint.layout import (shard_runs, chunk_sizes,
                                           chunks_for_runs,
                                           runs_cover_exactly)
from repro_torch.checkpoint.manifest import (MANIFEST_USER_STRING,
                                             SHARDS_FILE_USER_STRING,
                                             STATUS_USER_STRING, content_id)
from repro_torch.checkpoint.pytree_io import (DEFAULT_CHUNK_BYTES,
                                              DEFAULT_VENDOR,
                                              REFERENCE_VENDOR, flatten_named,
                                              read_manifest, restore,
                                              restore_leaf, save)
from repro_torch.checkpoint.sharding import (assign_shards, is_shard_name,
                                             read_sharded_manifest,
                                             save_sharded, shard_file,
                                             verify_set)
from repro_torch.checkpoint.manager import CheckpointManager, snapshot_to_host

__all__ = [
    "shard_runs", "chunk_sizes", "chunks_for_runs", "runs_cover_exactly",
    "MANIFEST_USER_STRING", "STATUS_USER_STRING", "SHARDS_FILE_USER_STRING",
    "content_id", "save", "restore", "restore_leaf", "read_manifest",
    "flatten_named", "DEFAULT_CHUNK_BYTES", "DEFAULT_VENDOR",
    "REFERENCE_VENDOR", "CheckpointManager", "snapshot_to_host",
    "verify_chain", "squash", "checkpoint_diff",
    "save_sharded", "read_sharded_manifest", "verify_set", "assign_shards",
    "shard_file", "is_shard_name",
]
