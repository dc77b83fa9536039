"""What every run shares: the look for a chip, the process's age, the
look for JAX, and the result line."""
from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Tuple

#: Top-level module names no run may hold once its window has closed: JAX,
#: its libraries and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def require_chips(n: int) -> None:
    """Exit with code 3, printing nothing on stdout, without ``n`` cards."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("perfbench: no CUDA device is available")
    if torch.cuda.device_count() < n:
        sys.exit(f"perfbench: the cell needs {n} cards, "
                 f"{torch.cuda.device_count()} are visible")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])           # field 22: starttime
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device, chips: int, peak_bytes: int) -> Dict[str, Any]:
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": chips, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def emit(result: Dict[str, Any], checks: List[Tuple[str, float, float]]) \
        -> None:
    """The compared numbers on stderr, last; the result as the last line
    of stdout, its ``checks`` key last."""
    result = dict(result)
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    sys.stdout.flush()
    for n, v, lim in checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
