"""What the readers of the program's own spans share: the traced window's
root spans in ``repro_torch.core.trace``'s collector, and the device time
of the spans under them.

The collector is the one the program's spans installed in the profiler
window (or one installed before it); a reader takes its last
``len(ctx.work)`` root spans of the step's name, so that a profile taken
again (``lib/trace.traced``) counts its last window alone.  Every reader
returns None where the program recorded no such spans or no device
interval (a program without spans, or a run off CUDA)."""
from __future__ import annotations

from typing import Iterable, List, Optional


class Window:
    """The spans of a traced window's root spans, the roots included."""

    def __init__(self, spans):
        self.spans = spans
        self.by_id = {s.id: s for s in spans}

    def device_s(self, keys: Iterable[str], spans=None) -> Optional[float]:
        """The summed device time of the spans named ``keys`` (all of
        ``spans`` when given), in seconds; None if one has no device
        interval."""
        keys = set(keys)
        total = 0
        for s in self.spans if spans is None else spans:
            if s.key in keys:
                if s.device_ns is None:
                    return None
                total += s.device_ns
        return total * 1e-9

    def outermost_recompute(self, keys: Iterable[str]) -> List:
        """The spans named ``keys`` that ran as remat's recompute, under
        no other span that did."""
        keys = set(keys)
        out = []
        for s in self.spans:
            if s.key not in keys or not s.args.get("recompute"):
                continue
            p = self.by_id.get(s.parent)
            while p is not None and not p.args.get("recompute"):
                p = self.by_id.get(p.parent)
            if p is None:
                out.append(s)
        return out


def window(ctx, root: str) -> Optional[Window]:
    """The last ``len(ctx.work)`` root spans named ``root`` (``cat.name``)
    and the spans under them, or None where there are fewer."""
    from repro_torch.core import trace
    c = trace.collector()
    n = len(ctx.work)
    if c is None or n == 0:
        return None
    spans = c.spans()
    roots = [s for s in spans if s.parent is None and s.key == root][-n:]
    if len(roots) < n:
        return None
    ids = {s.id for s in roots}
    return Window([s for s in spans if s.root in ids])


def share(ctx, root: str, part) -> Optional[float]:
    """100 · ``part(window)`` / the roots' device time, or None."""
    w = window(ctx, root)
    if w is None:
        return None
    whole = w.device_s([root])
    num = part(w)
    if whole is None or num is None or whole <= 0:
        return None
    return 100.0 * num / whole
