"""Archival with §3 per-element compression + selective random access, on
the PyTorch port — the counterpart of ``compressed_archive.py``.

Stores yi-6b's smoke model twice — raw and with per-chunk deflate — then
shows the property the paper's per-element design buys: restoring a
*single* leaf (``restore_leaf``, through the archive's ``.scdax`` index
sidecar) reads only the manifest and that leaf's chunks, counted here by
the trace's ``io.*.bytes``, without inflating the rest.

The weights are made on ``--device`` (the GPU unless ``--device cpu``).

Run:  PYTHONPATH=src python examples/torch_compressed_archive.py
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import (flatten_named, read_manifest, restore,
                                    restore_leaf, save)
from repro_torch.configs import get_config, smoke
from repro_torch.core import ScdaIndex, fopen_read
from repro_torch.core import trace
from repro_torch.models import init_lm
from repro_torch.runtime import resolve_device

LEAF = "embed"


def _bytes_read(tc: trace.TraceCollector) -> int:
    counters = tc.metrics.snapshot()["counters"]
    return sum(v for k, v in counters.items()
               if k.startswith("io.") and k.endswith(".bytes")
               and ".pread" in k)


def main(argv=None):
    """Save raw and compressed, restore both ways; returns the sizes, the
    ratio, and the bytes the selective restore read."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the weights live (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = smoke(get_config("yi-6b"))
    params = init_lm(cfg, 0, device=device)
    # make the weights compressible (real checkpoints often are: sparsity,
    # repeated structure, low-rank adapters, zero-init optimizer moments)
    params[LEAF] = (params[LEAF] * 100).round() / 100

    d = os.environ.get("SCDA_EXAMPLE_DIR")
    if d:
        os.makedirs(d, exist_ok=True)
    else:
        d = tempfile.mkdtemp(prefix="repro-archive-")
    raw, packed = os.path.join(d, "raw.scda"), os.path.join(d, "packed.scda")
    save(raw, params, step=1)
    save(packed, params, step=1, compressed=True, chunk_bytes=1 << 14)
    r, p = os.path.getsize(raw), os.path.getsize(packed)
    print(f"raw    : {r / 1e6:7.2f} MB")
    print(f"packed : {p / 1e6:7.2f} MB   (ratio {r / p:.2f}x)")

    # full restore round-trips exactly
    like = init_lm(cfg, 0, device="meta")
    out, _ = restore(packed, like, device=device)
    for (name, a), (_, b) in zip(flatten_named(out)[0],
                                 flatten_named(params)[0]):
        assert torch.equal(a, b), name
    print("compressed round-trip: exact")

    # selective access: restore only the embedding leaf, counting the
    # bytes its reads moved; the index sidecar lets it seek straight to
    # the leaf's section instead of scanning the section headers
    ScdaIndex.build(packed).write_sidecar()
    doc = read_manifest(packed)
    spec = next(s for s in doc["leaves"] if s["name"] == LEAF)
    tc = trace.TraceCollector()
    t0 = time.time()
    with trace.scoped(tc):
        sub = restore_leaf(packed, LEAF, device=device)
    dt = time.time() - t0
    assert torch.equal(sub, params[LEAF])
    read = _bytes_read(tc)
    print(f"selective restore of {LEAF!r} "
          f"({spec['nbytes'] / 1e6:.2f} MB) in {dt * 1e3:.1f} ms: "
          f"{read} of the archive's {p} bytes read "
          f"— other leaves never inflated")

    # the archive is an ordinary scda file: read one compressed element
    # directly with the core API
    with fopen_read(None, packed) as r_:
        r_.read_section_header(); r_.skip_data()          # status
        r_.read_section_header(); r_.skip_data()          # manifest
        hdr = r_.read_section_header(decode=True)         # first leaf
        first_chunk = r_.read_varray_elements([0])[0]
        print(f"leaf0 ({hdr.user_string!r}): chunk[0] = "
              f"{len(first_chunk)} bytes inflated on demand")
    return {"raw_bytes": r, "packed_bytes": p, "ratio": r / p,
            "leaf": LEAF, "leaf_bytes": spec["nbytes"], "read_bytes": read,
            "exact": True, "device": str(device), "dir": d}


if __name__ == "__main__":
    main()
