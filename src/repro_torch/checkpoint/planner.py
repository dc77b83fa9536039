"""Leaf placements — WHAT bytes a leaf contributes vs WHERE they land.

The checkpoint save path used to weld these together: one loop knew both
how to snapshot a leaf (device→host windows, or deterministic chunking)
and which section layout to emit (whole-file A sections, §3.4 compressed
pairs).  Delta checkpoints add a third layout — a varray holding only the
leaf's *changed* chunks — so the two concerns are split:

* a **placement** object owns one leaf's landing plan: its section user
  string, the payload snapshot callback, and the writer planning
  primitive that turns the payload into absolute-offset fragments;
* :func:`write_placements` is the single emission loop every layout
  shares — the serial byte oracle when ``window <= 0``, the overlapped
  save engine (:func:`repro.core.pipeline.run_write_pipeline`) otherwise.

Byte-identity between the two modes is structural, exactly as before:
each placement's serial write and pipelined plan call the same
:class:`repro.core.writer.ScdaWriter` primitive pair
(``write_array_windows`` / ``plan_array_windows``,
``write_varray`` / ``plan_encoded_varray`` / ``plan_varray``), so adding
a layout means adding a placement class, never touching the engine.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence

from repro_torch.core.pipeline import WriteItem, run_write_pipeline


class LeafPlacement:
    """One leaf's landing plan in the archive being written."""

    user: bytes

    def write_serial(self, f) -> None:
        """Emit the section(s) via the serial byte-oracle writer calls."""
        raise NotImplementedError

    def write_item(self, f, cursor: List[int]) -> WriteItem:
        """The placement as a save-engine item.

        ``cursor`` is the scheduler's shared one-cell cursor: plans run
        strictly in item order (pipeline contract) and each advances the
        cell — the serial writer's cursor discipline, while deflate and
        writeback float free.
        """
        raise NotImplementedError


@dataclasses.dataclass
class WindowPlacement(LeafPlacement):
    """Whole-leaf fixed array: ``A(user, N=nbytes, E=1)`` of this rank's
    canonical-stream windows — the raw full-checkpoint layout, valid
    under any writing partition."""

    user: bytes
    nbytes: int
    snapshot: Callable[[], Sequence]   # -> [(byte_offset, buffer), ...]
    key: Any = None

    def write_serial(self, f) -> None:
        f.write_array_windows(self.user, self.snapshot(),
                              N=self.nbytes, E=1)

    def write_item(self, f, cursor: List[int]) -> WriteItem:
        def plan(windows):
            frags, cursor[0] = f.plan_array_windows(
                self.user, windows, N=self.nbytes, E=1, cursor=cursor[0])
            return frags
        return WriteItem(key=self.key, snapshot=self.snapshot, plan=plan,
                         style=f.style)


@dataclasses.dataclass
class ChunkPlacement(LeafPlacement):
    """Varray of chunk buffers: the §3.4 compressed pair (``deflate``
    on the codec pool) or a raw V section.

    Carries a leaf's chunk *subset* in element order — every chunk for a
    full compressed leaf, only the changed chunks for a delta leaf.
    Single-rank by construction (the writer's varray planners enforce
    it), matching the compressed/delta save restriction.
    """

    user: bytes
    usizes: List[int]                  # uncompressed chunk sizes
    snapshot: Callable[[], Sequence]   # -> [chunk byte buffers]
    compressed: bool
    key: Any = None

    def write_serial(self, f) -> None:
        elements = [bytes(c) for c in self.snapshot()]
        f.write_varray(self.user, elements, [len(elements)],
                       self.usizes, encode=self.compressed)

    def write_item(self, f, cursor: List[int]) -> WriteItem:
        if self.compressed:
            def plan(streams):
                frags, cursor[0] = f.plan_encoded_varray(
                    self.user, self.usizes, streams, cursor[0])
                return frags
            return WriteItem(key=self.key, snapshot=self.snapshot,
                             plan=plan, deflate=True, style=f.style)

        def plan(chunks):
            frags, cursor[0] = f.plan_varray(self.user, chunks, cursor[0])
            return frags
        return WriteItem(key=self.key, snapshot=self.snapshot, plan=plan,
                         style=f.style)


def write_placements(f, placements: Sequence[LeafPlacement],
                     window: int) -> None:
    """Emit ``placements`` in order — serial oracle or overlapped engine.

    The one loop every checkpoint layout (whole-file, compressed,
    delta) funnels through; ``window <= 0`` takes the exact legacy
    serial write order.
    """
    if window > 0 and placements:
        cursor = [f.cursor]
        items = [p.write_item(f, cursor) for p in placements]
        try:
            run_write_pipeline(f._backend, items, window)
        finally:
            # Keep the writer's cursor coherent even on the error path —
            # the context manager's close (barriers included) runs next.
            f.cursor = cursor[0]
        return
    for p in placements:
        p.write_serial(f)
