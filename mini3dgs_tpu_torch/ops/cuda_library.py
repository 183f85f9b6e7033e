"""The library of the port's hand-written CUDA kernels: the one owner of
`csrc/`.

`kernel_library` compiles every `csrc/*.cu` with nvcc for sm_90a at first
use, links them into one library in `build/kernels/` and loads it with
ctypes, each `extern "C"` entry with its signature from `SIGNATURES`.
`launch` is how the ops call a launcher: on the tensors' device, on that
device's current stream, with a `RuntimeError` on a CUDA error, and with
the launch counted in the running total `LAUNCHES` and in the active
recording (utils/profiling.py).  This module imports no op.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from ..utils import profiling

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_ptr, _i64, _i32, _f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_float)
# (inst, n_live, tile_start, tile_count, num_tiles, tiles_x, tile_size,
#  tile0, ...)
_RASTER_HEAD = [_ptr, _i64, _ptr, _ptr, _i32, _i32, _i32, _i32]
# (10 inputs, n, width, height, sh_degree, antialias, scale_modifier, three
#  bounds (P1: radius_min, radius_max, cull_sigma; P2: the guard's), ...)
_PROJECT_HEAD = [_ptr] * 10 + [_i64] + [_i32] * 4 + [_f32] * 4
# Every entry of the library; each returns an int (0, or a CUDA error).
SIGNATURES = {
    "raster_fwd_launch": _RASTER_HEAD + [_ptr] * 2,     # out, stream
    "raster_fwd_t0_launch": _RASTER_HEAD + [_ptr] * 3,  # t0, out, stream
    # gout, [t0,] d_inst, [dt0,] part_g, sync, stream
    "raster_bwd_launch": _RASTER_HEAD + [_ptr] * 5,
    "raster_bwd_t0_launch": _RASTER_HEAD + [_ptr] * 7,
    "raster_fwd_blocks_per_sm": [_i32, _i32],           # tile_size, t0
    "raster_bwd_blocks_per_sm": [_i32, _i32, _i32],     # tile_size, pix, t0
    "project_fwd_launch": _PROJECT_HEAD + [_ptr] * 10,  # 9 outputs, stream
    # 5 cotangents, 6 gradients, stream
    "project_bwd_launch": _PROJECT_HEAD + [_ptr] * 12,
}
# Each launcher's running total in LAUNCHES and its counter in the active
# recording.
COUNTERS = {
    "raster_fwd_launch": ("raster_fwd.launches", "raster_fwd.launches"),
    "raster_fwd_t0_launch": ("raster_fwd.launches_t0",
                             "raster_fwd.launches_t0"),
    "raster_bwd_launch": ("raster_bwd.launches", "raster_bwd.launches"),
    "raster_bwd_t0_launch": ("raster_bwd.launches_t0",
                             "raster_bwd.launches_t0"),
    "project_fwd_launch": ("project_fwd.launches", "projection_kernel"),
    "project_bwd_launch": ("project_bwd.launches", "projection_bwd_kernel"),
}
# Launches since the process started, by running total.
LAUNCHES = {total: 0 for total, _ in COUNTERS.values()}
# A recording reports the raster launches even where it made none.
profiling.declare(*(c for _, c in COUNTERS.values()
                    if c.startswith("raster_")))


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date build was reused
    build_log: str        # nvcc/ptxas output (registers, spills)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                       "CUDA kernels cannot be built")


def kernel_sources(csrc: Path = CSRC_DIR) -> list:
    """The sources nvcc compiles, one object file each."""
    return sorted(csrc.glob("*.cu"))


def library_path(csrc: Path = CSRC_DIR) -> Path:
    """Where the library built from `csrc` lives: its name carries a hash of
    the nvcc flags and of every source and header (`*.cu`, `*.cuh`), so an
    edit to any of them builds a new one.  Builds nothing."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in kernel_sources(csrc) + sorted(csrc.glob("*.cuh")):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"kernels-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> str:
    """Compile every source to an object file, all nvcc processes started
    together, then link them into `path`.  Returns the compilers' output."""
    nvcc = _nvcc()
    sources = kernel_sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in sources]
    tmp = BUILD_DIR / f"{stem}.tmp"
    try:
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        log = "".join(proc.communicate()[0] for proc in procs)
        for proc, src in zip(procs, sources):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({proc.returncode}):\n{log}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{log}")
        os.replace(tmp, path)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return log


@functools.cache
def kernel_library() -> KernelLibrary:
    """Build (once per set of sources and flags) and load the library that
    holds every kernel of `csrc/`."""
    path = library_path()
    seconds, log = 0.0, ""
    if not path.exists():
        t0 = time.perf_counter()
        log = _build(path)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for entry, argtypes in SIGNATURES.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, _i32
    return KernelLibrary(lib, path, seconds, log)


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the launcher `entry` (a key of COUNTERS) on `device` with `args`
    (a tensor as its data pointer, None as a null pointer) and that
    device's current stream; raise on a CUDA error.  Counts the launch in
    `LAUNCHES` and in the active recording."""
    fn = getattr(kernel_library().lib, entry)
    # The device of the tensors, not the current one, runs the kernel.
    with torch.cuda.device(device):
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args),
                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {rc}")
    total, counter = COUNTERS[entry]
    LAUNCHES[total] += 1
    profiling.count(counter, 1)
