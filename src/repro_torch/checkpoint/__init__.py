"""Checkpoint/restart of torch state on the scda format (flat layout).

    from repro_torch.checkpoint import save, restore

    save("/ckpts/w.scda", params, step=1000)
    params, step = restore("/ckpts/w.scda", like=params, device="cuda")
"""
from repro_torch.checkpoint.layout import (shard_runs, chunk_sizes,
                                           chunks_for_runs,
                                           runs_cover_exactly)
from repro_torch.checkpoint.manifest import (MANIFEST_USER_STRING,
                                             STATUS_USER_STRING, content_id)
from repro_torch.checkpoint.pytree_io import (DEFAULT_CHUNK_BYTES,
                                              DEFAULT_VENDOR,
                                              REFERENCE_VENDOR, flatten_named,
                                              read_manifest, restore,
                                              restore_leaf, save)

__all__ = [
    "shard_runs", "chunk_sizes", "chunks_for_runs", "runs_cover_exactly",
    "MANIFEST_USER_STRING", "STATUS_USER_STRING", "content_id", "save",
    "restore", "restore_leaf", "read_manifest", "flatten_named",
    "DEFAULT_CHUNK_BYTES", "DEFAULT_VENDOR", "REFERENCE_VENDOR",
]
