"""The run's surroundings: cache directories inside the checkout, the
import check, and the host's and card's state printed beside the result."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

# Top-level module names that may not be loaded in a run: JAX and the JAX
# package.  The measured package's name begins with the latter's, so names
# are compared whole, up to the first dot.
FORBIDDEN = ("jax", "jaxlib", "flax", "mini3dgs_tpu")


def set_cache_dirs(root: Path) -> None:
    """Fixed cache directories under the checkout's `build/` (the measured
    package builds its kernels into `build/kernels/` itself), so that only
    a checkout's first run builds."""
    build = root / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)


def loaded(names=FORBIDDEN, modules=None) -> list:
    """The names of `names` that are the top-level name of a loaded
    module."""
    modules = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in list(modules)}
    return sorted(n for n in names if n in tops)


def host_launch_us(device, n: int = 2000) -> float:
    """Host microseconds a launch of a one-element kernel takes, the card
    idle before and far ahead of the host throughout."""
    import torch
    x = torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    t1 = time.perf_counter()
    torch.cuda.synchronize(device)
    return (t1 - t0) / n * 1e6


def card_state(index: int = 0) -> str:
    """The card's name, SM clock, power draw and limit, as nvidia-smi
    reads them, or why they were not read."""
    query = "name,clocks.sm,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
             "-i", str(index)], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"
    return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"
