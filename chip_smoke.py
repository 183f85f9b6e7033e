"""On-card smoke run of the PyTorch/CUDA port (mini3dgs_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

It builds the CUDA raster kernels from mini3dgs_tpu_torch/csrc/ and holds
each against its plain PyTorch version on the card (edge cases at tile 16
and 32, a ragged image edge, and the golden rasterizer and its autograd on a
small scene), checks that binning on the card equals binning on the CPU,
renders the flagship 100,000-Gaussian SH-3 scene at 800x800 through
`render`, runs the novel-view entry point, takes twelve full-width train
steps (then one densify and one prune step) on that scene, and runs the
training entry point.  Any failure raises; nothing falls back to the CPU.
The last three lines are a JSON object with one entry per kernel, then
nvidia-smi's name and power limit, and {"ok": true, "device": {...}}.
"""

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
VIEW_SIZE = 800
N_GAUSSIANS = 100_000
CAPACITY = 2 ** 17
TRAIN_STEPS = 12

# The card's published peaks (NVIDIA H100 SXM data sheet): HBM3 bytes/s and
# float32 operations/s outside the tensor cores (an FMA counts as two).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
# Float32 operations the raster functions need per pixel x instance pair,
# by how far the pair gets (an FMA as two, expf and a true division as eight
# each).  A pair whose pixel's gate has closed needs none.
# Every pair whose gate is open: the gate test 2; dx, dy 2; the quadratic
# form 8; expf 8; min(., 1) 1; the w >= 1e-5 test 1.
PAIR_TEST_OPS = 22
# Forward, further, where w >= 1e-5: op*w 1; min 1; T*alpha 1; four
# accumulator FMAs and one add 9; T update 2.
FWD_LIVE_OPS = 14
# Backward, further, where w >= 1e-5: op*w 1; min 1; T*alpha 1; u 8; running
# sum 2; four colour FMAs 8; the two tests of op*w 2; T update 2.
BWD_LIVE_OPS = 25
# Backward, further, where 0 < op*w < 1: d_alpha 13; d_op 2; the w < 1 test 1.
BWD_ALPHA_OPS = 16
# Backward, further, where also w < 1: d_lw 2; the five geometric terms 20.
BWD_GEOM_OPS = 22


def gate(a: torch.Tensor, b: torch.Tensor, name: str) -> float:
    """The cliff-aware forward gate of scripts/verify_chip.py plus a mean
    bound: p99.9 |diff| < 1e-3, at most max(8, n/100000) entries over 1e-3
    (isolated early-stop flips, each <= the remaining transmittance
    5e-3), max |diff| < 5.5e-3 and mean |diff| < 2e-5.  Returns max |diff|."""
    d = (a.double() - b.double()).abs().flatten().cpu().numpy()
    if not np.isfinite(d).all():
        raise AssertionError(f"{name}: non-finite values")
    p999 = float(np.quantile(d, 0.999))
    big = int((d > 1e-3).sum())
    ok = (p999 < 1e-3 and big <= max(8, d.size // 100_000)
          and d.max() < 5.5e-3 and d.mean() < 2e-5)
    print(f"    {name:22s} max={d.max():.3e} p99.9={p999:.3e} "
          f"mean={d.mean():.3e} >1e-3: {big}/{d.size} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel and reference disagree")
    return float(d.max())


def gate_acc(acc_k, acc_p, name) -> float:
    """Gate raw [T, 8, P] accumulators: rgb, alpha, depth / max depth."""
    if bool((acc_k[:, 5:] != 0).any()):
        raise AssertionError(f"{name}: pad rows 5..7 are not zero")
    scale = max(float(acc_p[:, 3].abs().max()), 1e-6)
    return max(gate(acc_k[:, 0:3], acc_p[:, 0:3], f"{name} rgb"),
               gate(acc_k[:, 4], acc_p[:, 4], f"{name} alpha"),
               gate(acc_k[:, 3] / scale, acc_p[:, 3] / scale,
                    f"{name} depth/max"))


def cuda_ms(fn, reps: int = 5) -> float:
    """Median of `reps` CUDA-event timings of fn() after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def gate_rows(got: torch.Tensor, want: torch.Tensor, name: str) -> float:
    """Gate the backward kernel's gradient [10, n] against the plain
    version's, row by row, each normalised by the plain row's largest
    magnitude: rel-L2 < 1e-4, at most max(8, n/100000) entries over 1e-3
    (the early stop and the w >= 1e-5 skip are cliffs: a rounding
    difference that flips one moves isolated entries), and the largest
    normalised error < 2e-2.  Returns that largest error."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite gradient")
    g, w = got.double(), want.double()
    scale = w.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    d = (g - w).abs() / scale
    l2 = (g - w).norm(dim=1) / w.norm(dim=1).clamp(min=1e-30)
    big = int((d > 1e-3).sum())
    worst, worst_l2 = float(d.max()), float(l2.max())
    ok = (worst_l2 < 1e-4 and big <= max(8, d.numel() // 100_000)
          and worst < 2e-2)
    print(f"    {name:22s} rows max={worst:.3e} rel-L2={worst_l2:.3e} "
          f">1e-3: {big}/{d.numel()} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: backward kernel and plain disagree")
    return worst


def seeded_gout(acc: torch.Tensor, seed: int) -> torch.Tensor:
    """A cotangent of the accumulators: N(0,1) on the 5 live rows, 0 on
    the pad rows."""
    gen = torch.Generator(device=acc.device).manual_seed(seed)
    gout = torch.zeros_like(acc)
    gout[:, :5] = torch.randn(acc[:, :5].shape, generator=gen,
                              device=acc.device)
    return gout


def edge_stream(tile_size, tiles_x, tiles_y, seed, device):
    """Seeded instance stream with the kernel's edge cases: empty tiles,
    slices of 1, 255, 256, 257 and 513 instances (the kernel stages 256 at
    a time), alpha = 1 splats (opacity 1 centred on a pixel), and tiles
    whose first splats are broad and opaque so they saturate early."""
    rng = np.random.default_rng(seed)
    n_tiles = tiles_x * tiles_y
    counts = rng.integers(0, 700, n_tiles)
    counts[rng.random(n_tiles) < 0.1] = 0
    counts[:6] = [0, 1, 255, 256, 257, 513]
    counts[6::7] = np.maximum(counts[6::7], 40)  # tiles that saturate
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    n = int(counts.sum())
    tile = np.repeat(np.arange(n_tiles), counts)
    ox = (tile % tiles_x) * tile_size
    oy = (tile // tiles_x) * tile_size
    s = np.zeros((10, n), np.float32)
    s[0] = ox + rng.uniform(-6, tile_size + 6, n)
    s[1] = oy + rng.uniform(-6, tile_size + 6, n)
    sig = rng.uniform(0.7, 0.5 * tile_size, (2, n))
    rho = rng.uniform(-0.7, 0.7, n)
    det = (1 - rho ** 2) * sig[0] ** 2 * sig[1] ** 2
    s[2] = -0.5 * sig[1] ** 2 / det
    s[3] = rho * sig[0] * sig[1] / det
    s[4] = -0.5 * sig[0] ** 2 / det
    s[5] = rng.uniform(0.02, 0.99, n)
    s[6:9] = rng.random((3, n))
    s[9] = rng.uniform(0.5, 6.0, n)
    one = rng.random(n) < 0.05
    s[0, one] = np.floor(s[0, one])
    s[1, one] = np.floor(s[1, one])
    s[5, one] = 1.0
    for t in range(6, n_tiles, 7):  # early saturation
        j = slice(starts[t], starts[t] + min(counts[t], 30))
        s[2, j], s[3, j], s[4, j], s[5, j] = -1e-4, 0.0, -1e-4, 0.95
    to = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return to(s, torch.float32), to(starts, torch.int32), \
        to(counts, torch.int32)


def pair_counts(rc, stream, start, count, tiles_x, ts) -> dict:
    """Pixel x instance pairs of this stream by how far the raster functions
    have to take them (counted with the plain version's terms): `open`, the
    pixel's gate is open before the instance; of those `live`, w >= 1e-5;
    of those `alpha`, 0 < op*w < 1 (d_alpha is needed); of those `geom`,
    w < 1 (the geometric gradient is needed)."""
    T, P = start.shape[0], ts * ts
    px, py = rc._pixel_coords(T, tiles_x, ts, stream.device)
    trans = torch.ones(T, P, device=stream.device)
    lanes = torch.arange(64, device=stream.device)[None, :]
    st, ct = start.long()[:, None], count.long()[:, None]
    n = dict(open=0, live=0, alpha=0, geom=0)
    for base in range(0, int(count.max()), 64):
        m = rc._slice_terms(stream, st, ct, px, py, trans, base, lanes)
        live = m["gate"] & m["live"]
        alpha = live & (m["a_raw"] < 1.0) & (m["a_raw"] > 0.0)
        n["open"] += int((m["gate"] & m["valid"][:, None, :]).sum())
        n["live"] += int(live.sum())
        n["alpha"] += int(alpha.sum())
        n["geom"] += int((alpha & (m["w"] < 1.0)).sum())
        trans = m["trans"]
    return n


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def load_script(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    # ---- 1. device ----------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA device")
    sys.path.insert(0, str(REPO))
    from mini3dgs_tpu_torch import convert
    from mini3dgs_tpu_torch.config import TrainingConfig
    from mini3dgs_tpu_torch.core.gaussians import scene_extent_of
    from mini3dgs_tpu_torch.core.loss import gaussian_loss
    from mini3dgs_tpu_torch.ops import raster_cuda as rc
    from mini3dgs_tpu_torch.ops import raster_ref
    from mini3dgs_tpu_torch.ops.binning import bin_gaussians
    from mini3dgs_tpu_torch.ops.projection import project_gaussians
    from mini3dgs_tpu_torch.ops.renderer import RenderSettings, render
    from mini3dgs_tpu_torch.train import trainer
    from mini3dgs_tpu_torch.utils.gaussian_ply import export_gaussians_ply
    from mini3dgs_tpu_torch.utils.metrics import psnr
    from mini3dgs_tpu_torch.utils.vis import turntable_cameras

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"[1 device] {kind} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" cuda {torch.version.cuda} | nvcc {rc._nvcc()}", flush=True)

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    lib = rc.kernel_library()
    sources = [str(p.relative_to(REPO)) for p in rc.kernel_sources()]
    print(f"[2 build] {lib.path.relative_to(REPO)} from {sources} "
          f"({' '.join(rc.NVCC_FLAGS)}): nvcc {lib.build_seconds:.2f} s, "
          f"load {time.perf_counter() - t0:.2f} s", flush=True)
    for line in lib.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            print(f"    ptxas: {line.strip()}")

    # ---- 3. forward kernel vs plain on the card -----------------------
    print("[3 forward kernel vs plain]", flush=True)
    launches_before = rc.raster_fwd.launches
    edge = {}
    for ts in rc.KERNEL_TILE_SIZES:
        tiles_x, tiles_y = 800 // ts // 2, 600 // ts // 2
        stream, start, count = edge_stream(ts, tiles_x, tiles_y, ts, dev)
        acc_k = rc.raster_fwd(stream, start, count, tiles_x, ts)
        acc_p = rc.raster_fwd_plain(stream, start, count, tiles_x, ts)
        torch.cuda.synchronize()
        print(f"  edge stream tile {ts}: {tiles_x}x{tiles_y} tiles, "
              f"{stream.shape[1]} instances")
        gate_acc(acc_k, acc_p, f"tile{ts} edge")
        if float(acc_k[6::7, 4].min()) < 0.995:
            raise AssertionError("saturating tiles did not saturate")
        edge[ts] = (stream, start, count, tiles_x, ts, acc_k)
    params, alive, cam = convert.flagship_scene_numpy(8192, 6000, seed=5)
    g_small = convert.gaussians_from_numpy(params, alive, dev)
    Hr, Wr = 250, 333  # a ragged edge at both tile sizes
    cam_r = convert.camera_from_numpy(**cam, width=Wr, height=Hr, device=dev)
    bg = torch.ones(3, device=dev)
    ragged = {}
    for ts in rc.KERNEL_TILE_SIZES:
        proj = project_gaussians(g_small, cam_r)
        b, stream = rc.tile_stream(proj, Hr, Wr, ts)
        tiles_x = -(-Wr // ts)
        acc_k = rc.raster_fwd(stream, b.tile_start, b.tile_count, tiles_x, ts)
        acc_p = rc.raster_fwd_plain(stream, b.tile_start, b.tile_count,
                                    tiles_x, ts)
        print(f"  ragged {Wr}x{Hr} tile {ts}: n_live {b.n_live}")
        gate_acc(acc_k, acc_p, f"tile{ts} ragged")
        out_k = rc.rasterize_tiles(proj, Hr, Wr, bg, tile_size=ts)
        out_g = raster_ref.rasterize_image(
            proj.means2d, proj.conic, proj.depth, proj.color, proj.opacity,
            proj.visible, Hr, Wr, bg, radius=proj.radius, tile_size=ts,
            pixel_block=16384)
        gate(out_k["image"], out_g["image"], f"tile{ts} vs golden image")
        gate(out_k["alpha"], out_g["alpha"], f"tile{ts} vs golden alpha")
        ragged[ts] = (stream, b.tile_start, b.tile_count, tiles_x, ts, acc_k)
    print(f"  launches in phase 3: {rc.raster_fwd.launches - launches_before}")

    # ---- 3b. backward kernel vs plain on the card ---------------------
    print("[3b backward kernel vs plain]", flush=True)
    launches_before = rc.raster_bwd.launches
    for name, cases in (("edge", edge), ("ragged", ragged)):
        for ts, (stream, start, count, tiles_x, _, acc_k) in cases.items():
            args = (stream, start, count, tiles_x, ts, acc_k,
                    seeded_gout(acc_k, 100 + ts))
            d_k = rc.raster_bwd(*args)
            d_again = rc.raster_bwd(*args)
            d_p = rc.raster_bwd_plain(*args)
            torch.cuda.synchronize()
            gate_rows(d_k, d_p, f"tile{ts} {name}")
            if not torch.equal(d_k, d_again):
                raise AssertionError(f"tile{ts} {name}: two launches of the "
                                     "backward kernel differ")
            if name != "edge":
                continue
            # Tiles 6, 13, ... saturate within their first 30 splats: the
            # block leaves its loop, and what lies behind must be exact 0.
            sat = torch.arange(6, start.shape[0], 7, device=dev)
            behind = torch.cat([
                torch.arange(int(start[t]) + 128,
                             int(start[t]) + int(count[t]), device=dev)
                for t in sat.tolist() if int(count[t]) > 128])
            if behind.numel() < 1000:
                raise AssertionError("too few rows behind an early exit")
            if bool((d_k[:, behind] != 0).any()) \
                    or bool((d_p[:, behind] != 0).any()):
                raise AssertionError(f"tile{ts} edge: rows behind an early "
                                     "exit are not exactly 0")
            if not bool((d_k[:, start[sat].long()] != 0).any()):
                raise AssertionError("saturating tiles got no gradient")
            print(f"    tile{ts} edge: {behind.numel()} rows behind an early "
                  "exit exactly 0; two launches bitwise equal")
    print(f"  launches in phase 3b: "
          f"{rc.raster_bwd.launches - launches_before}")

    # ---- 3c. render gradients vs the golden's autograd ----------------
    print("[3c render gradients vs golden autograd]", flush=True)
    target_r = torch.rand(3, Hr, Wr, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(3))
    # The flagship scene is isotropic, so its true rotation gradient is 0
    # and its error would be noise over noise: make the splats anisotropic.
    aniso = torch.tensor([0.0, 0.45, -0.5], device=dev)
    g_aniso = g_small.replace(scaling=g_small.scaling + aniso)
    grads = {}
    for raster in ("tiles", "golden"):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in g_aniso.params().items()}
        out = render(g_aniso.with_params(leaves), cam_r, RenderSettings(
            image_height=Hr, image_width=Wr, bg_color=(1.0, 1.0, 1.0),
            tile_size=32, raster=raster))
        loss = (((out["image"] - target_r) ** 2).mean()
                + 0.1 * out["alpha"].mean() + 0.01 * out["depth"].mean())
        names = [k for k in leaves if k != "features_rest"]
        grads[raster] = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
    for k, gt in grads["tiles"].items():
        gg = grads["golden"][k]
        a, b = gt[g_small.alive].double(), gg[g_small.alive].double()
        l2 = float((a - b).norm() / b.norm())
        worst = float((a - b).abs().max() / b.abs().max())
        # the gate of scripts/verify_chip.py: rel-L2 < 3e-3 per group
        ok = bool(torch.isfinite(a).all()) and l2 < 3e-3
        print(f"    grad {k:12s} max={worst:.3e} rel-L2={l2:.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"render gradient {k} disagrees with the "
                                 "golden's")

    # ---- 4. binning on the card == binning on the CPU -----------------
    params, alive, cam = convert.flagship_scene_numpy(CAPACITY, N_GAUSSIANS,
                                                      seed=0)
    rng = np.random.default_rng(1)
    params["features_rest"][:N_GAUSSIANS] = rng.normal(
        0.0, 0.1, (N_GAUSSIANS, 15, 3))
    g = convert.gaussians_from_numpy(params, alive, dev)
    bench_cam = convert.camera_from_numpy(**cam, width=VIEW_SIZE,
                                          height=VIEW_SIZE, device=dev)
    proj = project_gaussians(g, bench_cam, color_mode="sh", sh_degree=3)
    b_gpu = bin_gaussians(proj, VIEW_SIZE, VIEW_SIZE, 32)
    b_cpu = bin_gaussians(type(proj)(*(f.cpu() for f in proj)), VIEW_SIZE,
                          VIEW_SIZE, 32)
    for f in ("tile_start", "tile_count", "s_rank", "order", "counts_gid"):
        if not torch.equal(getattr(b_gpu, f).cpu(), getattr(b_cpu, f)):
            raise AssertionError(f"binning on the card differs: {f}")
    if b_gpu.n_live != b_cpu.n_live:
        raise AssertionError("binning on the card differs: n_live")
    print(f"[4 binning] {VIEW_SIZE}^2 tile 32, {N_GAUSSIANS} Gaussians: "
          f"n_live {b_gpu.n_live}, per-tile lists identical on card and CPU",
          flush=True)

    # ---- 5. the render slice: two 800^2 views through render ----------
    settings = RenderSettings(image_height=VIEW_SIZE, image_width=VIEW_SIZE,
                              bg_color=(1.0, 1.0, 1.0), tile_size=32,
                              color_mode="sh", sh_degree=3)
    cams = [bench_cam] + turntable_cameras(3, width=VIEW_SIZE,
                                           image_height=VIEW_SIZE,
                                           device=dev)[1:2]
    with torch.no_grad():
        render(g, cams[0], settings)  # warm-up (allocator, kernel load)
        torch.cuda.synchronize()
        rc.raster_fwd.launches = rc.raster_bwd.launches = 0
        outs, render_ms = [], []
        for cam_v in cams:
            t0 = time.perf_counter()
            outs.append(render(g, cam_v, settings))
            torch.cuda.synchronize()
            render_ms.append((time.perf_counter() - t0) * 1e3)
        render_launches = rc.raster_fwd.launches
    if render_launches != len(cams) or rc.raster_bwd.launches != 0:
        raise AssertionError(f"render launched the forward kernel "
                             f"{render_launches} times for {len(cams)} views")
    print(f"[5 render slice] {len(cams)} views {VIEW_SIZE}x{VIEW_SIZE}, "
          f"{N_GAUSSIANS} Gaussians (pool {CAPACITY}), SH 3, tile 32, white "
          f"bg: forward launches {render_launches}", flush=True)
    fwd_ms, fwd_plain_ms, fwd_err = [], [], 0.0
    tiles_x = -(-VIEW_SIZE // 32)
    for i, (cam_v, out) in enumerate(zip(cams, outs)):
        img = out["image"]
        finite = torch.isfinite(img).all() & torch.isfinite(out["depth"]).all()
        if img.shape != (3, VIEW_SIZE, VIEW_SIZE) or not bool(finite):
            raise AssertionError(f"view {i}: bad image")
        if not 0.5 < float(out["alpha"].max()) <= 1.0:
            raise AssertionError(f"view {i}: no opaque pixel")
        proj = project_gaussians(g, cam_v, color_mode="sh", sh_degree=3)
        b, stream = rc.tile_stream(proj, VIEW_SIZE, VIEW_SIZE, 32)
        args = (stream, b.tile_start, b.tile_count, tiles_x, 32)
        acc_k, acc_p = rc.raster_fwd(*args), rc.raster_fwd_plain(*args)
        print(f"  view {i}: n_live {b.n_live}")
        fwd_err = max(fwd_err, gate_acc(acc_k, acc_p, f"view{i}"))
        fwd_ms.append(cuda_ms(lambda: rc.raster_fwd(*args)))
        fwd_plain_ms.append(cuda_ms(lambda: rc.raster_fwd_plain(*args)))
        with torch.no_grad():
            plain_img = rc.rasterize_tiles(proj, VIEW_SIZE, VIEW_SIZE,
                                           torch.ones(3, device=dev),
                                           tile_size=32,
                                           fwd=rc.raster_fwd_plain)["image"]
        p = float(psnr(img, plain_img))
        if out["n_live"] != b.n_live or p < 50.0:
            raise AssertionError(f"view {i}: render and plain disagree")
        print(f"  view {i}: n_live {b.n_live}  kernel {fwd_ms[-1]:.3f} ms"
              f"  plain {fwd_plain_ms[-1]:.3f} ms  render {render_ms[i]:.2f} ms"
              f"  PSNR(render, plain) {p:.2f} dB", flush=True)

    # ---- 6. render entry point ---------------------------------------
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        ply = tmp / "flagship.ply"
        export_gaussians_ply(g, str(ply))
        mod = load_script("render_novel_view_torch")
        rc.raster_fwd.launches = 0
        rc_main = mod.main(["--ply", str(ply), "--output", str(tmp / "out"),
                            "--n-frames", "2", "--size", str(VIEW_SIZE),
                            "--sh-degree", "3", "--color-mode", "sh",
                            "--tile-size", "32", "--bg", "1,1,1",
                            "--device", "cuda"])
        if rc_main != 0 or rc.raster_fwd.launches != 2:
            raise AssertionError("entry point did not render 2 frames "
                                 "through the kernel")
        for i in range(2):
            rgba = np.load(tmp / "out" / f"frame_{i:04d}.npy")
            if rgba.shape != (4, VIEW_SIZE, VIEW_SIZE) or \
                    not np.isfinite(rgba).all() or rgba[3].max() <= 0:
                raise AssertionError(f"entry point frame {i} is bad")
        print(f"[6 render entry point] scripts/render_novel_view_torch.py: 2 "
              f"finite {VIEW_SIZE}^2 frames, alpha max "
              f"{float(rgba[3].max()):.3f}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 7. the train slice at full width -----------------------------
    # The flagship scene (seed 0, zero SH rest) is trained towards a render
    # of the seeded SH-3 set `g` of phase 4 moved to other positions (seed
    # 7), from the bench view.
    t_params, t_alive, _ = convert.flagship_scene_numpy(CAPACITY, N_GAUSSIANS,
                                                        seed=7)
    t_params["features_rest"] = params["features_rest"]
    with torch.no_grad():
        target = render(convert.gaussians_from_numpy(t_params, t_alive, dev),
                        bench_cam, settings)["image"]
    train_cam = bench_cam.replace(image=target)
    s_params, s_alive, _ = convert.flagship_scene_numpy(CAPACITY, N_GAUSSIANS,
                                                        seed=0)
    g0 = convert.gaussians_from_numpy(s_params, s_alive, dev)
    config = TrainingConfig(
        iterations=TRAIN_STEPS, image_height=VIEW_SIZE, image_width=VIEW_SIZE,
        background_color=[1.0, 1.0, 1.0], tile_size=32, color_mode="sh",
        sh_degree=3, capacity=CAPACITY)
    extent = float(scene_extent_of(g0))
    config = trainer.scale_position_lr(config, extent)
    state = trainer.create_train_state(g0, config)
    state, _ = trainer.train_step(state, train_cam, config, settings)  # warm
    state = trainer.create_train_state(g0, config)
    torch.cuda.synchronize()
    rc.raster_fwd.launches = rc.raster_bwd.launches = 0
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, train_cam, config,
                                            settings)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["total_loss"]))
    train_launches = (rc.raster_fwd.launches, rc.raster_bwd.launches)
    if train_launches != (TRAIN_STEPS, TRAIN_STEPS):
        raise AssertionError(f"{TRAIN_STEPS} train steps launched the "
                             f"kernels {train_launches} times")
    dead = ~g0.alive
    for k, v in state.gaussians.params().items():
        for what, t in (("parameter", v), ("Adam mu", state.opt_state.mu[k]),
                        ("Adam nu", state.opt_state.nu[k])):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"non-finite {what} {k}")
        if not torch.equal(v[dead], getattr(g0, k)[dead]):
            raise AssertionError(f"dead slots of {k} moved")
        if torch.equal(v, getattr(g0, k)):
            raise AssertionError(f"{k} did not train")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"loss did not fall: {losses}")
    if float(state.gaussians.denom.max()) != TRAIN_STEPS:
        raise AssertionError("the densify statistics were not accumulated")
    print(f"[7 train slice] {TRAIN_STEPS} steps {VIEW_SIZE}x{VIEW_SIZE}, "
          f"{N_GAUSSIANS} Gaussians (pool {CAPACITY}), SH 3, tile 32: "
          f"launches fwd/bwd {train_launches}, loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}, n_live {metrics['render_instances']}, step ms "
          f"median {np.median(step_ms):.2f} min {min(step_ms):.2f} max "
          f"{max(step_ms):.2f}", flush=True)
    noise = torch.randn(CAPACITY, 3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    n_before = state.gaussians.num_alive()
    dstate, ds = trainer.densify_step(state, noise, extent, config)
    if ds["n_alive"] != n_before + ds["n_split"] + ds["n_clone"] \
            - ds["n_pruned"] - ds["n_dropped"] or ds["n_alive"] > CAPACITY \
            or ds["n_split"] + ds["n_clone"] == 0 \
            or float(dstate.gaussians.denom.max()) != 0.0:
        raise AssertionError(f"densify_step counts are off: {ds}")
    pstate, n_pruned = trainer.prune_step(state, config)
    if pstate.gaussians.num_alive() != n_before - n_pruned:
        raise AssertionError("prune_step counts are off")
    dstate, _ = trainer.train_step(dstate, train_cam, config, settings)
    if not bool(torch.isfinite(dstate.gaussians.xyz).all()):
        raise AssertionError("a step after densify gave non-finite xyz")
    print(f"  densify_step: {ds}; prune_step: {n_pruned} pruned; one more "
          f"step on the densified state is finite", flush=True)

    # B1 and B2 on the trained state's bench-view stream, with the loss's
    # own cotangent of the accumulators.
    proj = project_gaussians(state.gaussians, bench_cam, color_mode="sh",
                             sh_degree=3)
    b, stream = rc.tile_stream(proj, VIEW_SIZE, VIEW_SIZE, 32)
    fargs = (stream, b.tile_start, b.tile_count, tiles_x, 32)
    acc_leaf = rc.raster_fwd(*fargs).requires_grad_(True)
    image = rc.compose_image(acc_leaf, VIEW_SIZE, VIEW_SIZE, 32,
                             torch.ones(3, device=dev))[0]
    gout, = torch.autograd.grad(gaussian_loss(image, target)[0], acc_leaf)
    if bool((gout[:, 5:] != 0).any()):
        raise AssertionError("the cotangent's pad rows are not zero")
    bargs = (*fargs, acc_leaf.detach(), gout)
    d_k, d_p = rc.raster_bwd(*bargs), rc.raster_bwd_plain(*bargs)
    bwd_err = gate_rows(d_k, d_p, "train view")
    fwd_err = max(fwd_err, gate_acc(acc_leaf.detach(),
                                    rc.raster_fwd_plain(*fargs), "train view"))
    t_fwd = cuda_ms(lambda: rc.raster_fwd(*fargs))
    t_fwd_plain = cuda_ms(lambda: rc.raster_fwd_plain(*fargs), reps=2)
    t_bwd = cuda_ms(lambda: rc.raster_bwd(*bargs))
    t_bwd_plain = cuda_ms(lambda: rc.raster_bwd_plain(*bargs), reps=2)
    pairs = pair_counts(rc, *fargs)
    n_live, T, P = b.n_live, b.tile_start.shape[0], 32 * 32
    fwd_bound = bound(40 * n_live + 8 * T + 4 * rc.N_ACC * T * P,
                      PAIR_TEST_OPS * pairs["open"]
                      + FWD_LIVE_OPS * pairs["live"])
    bwd_bound = bound(80 * n_live + 8 * T + 2 * 4 * 5 * T * P,
                      PAIR_TEST_OPS * pairs["open"]
                      + BWD_LIVE_OPS * pairs["live"]
                      + BWD_ALPHA_OPS * pairs["alpha"]
                      + BWD_GEOM_OPS * pairs["geom"])
    print(f"  train view: n_live {n_live}, n_live x P {n_live * P}, pairs "
          f"with the gate open {pairs['open']}, of those w >= 1e-5 "
          f"{pairs['live']}, of those 0 < op*w < 1 {pairs['alpha']}, of "
          f"those w < 1 {pairs['geom']}\n"
          f"  raster_fwd {t_fwd:.3f} ms (plain {t_fwd_plain:.1f}, bound "
          f"{fwd_bound[0]:.4f} by {fwd_bound[1]})\n"
          f"  raster_bwd {t_bwd:.3f} ms (plain {t_bwd_plain:.1f}, bound "
          f"{bwd_bound[0]:.4f} by {bwd_bound[1]})", flush=True)

    # ---- 8. train entry point ----------------------------------------
    mod = load_script("train_torch")
    rc.raster_fwd.launches = rc.raster_bwd.launches = 0
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_main = mod.main([
            "--iterations", "8", "--size", str(VIEW_SIZE), "--n-gaussians",
            str(N_GAUSSIANS), "--capacity", str(CAPACITY), "--n-cameras", "1",
            "--log-interval", "4", "--densify-from-iter", "8",
            "--densify-interval", "8", "--sh-increase-interval", "2",
            "--device", "cuda"])
    log = [json.loads(x) for x in buf.getvalue().splitlines()]
    final = log[-1]
    if rc_main != 0 or rc.raster_bwd.launches != 8 \
            or "n_clone" not in log[-2] or log[-2]["sh_degree"] != 3 \
            or not final["last_loss"] < final["first_loss"] \
            or not np.isfinite([final["psnr_start"], final["psnr_end"]]).all():
        raise AssertionError(f"the train entry point failed: {final}")
    print(f"[8 train entry point] scripts/train_torch.py: 8 iterations at "
          f"{VIEW_SIZE}^2, SH unlocked to 3, densify {log[-2]['n_split']} split "
          f"{log[-2]['n_clone']} clone, backward launches "
          f"{rc.raster_bwd.launches}: {json.dumps(final)}", flush=True)

    # ---- 9. result ----------------------------------------------------
    print(json.dumps({"kernels": [
        {"name": "raster_fwd", "route": "cuda",
         "source": "mini3dgs_tpu_torch/csrc/raster_fwd.cu",
         "replaces": "mini3dgs_tpu/ops/raster_pallas.py:288",
         "launches": train_launches[0], "launches_render": render_launches,
         "max_abs_err": fwd_err,
         "ms": t_fwd, "plain_ms": t_fwd_plain, "bound_ms": fwd_bound[0],
         "bound_by": fwd_bound[1], "library_ms": None},
        {"name": "raster_bwd", "route": "cuda",
         "source": "mini3dgs_tpu_torch/csrc/raster_bwd.cu",
         "replaces": "mini3dgs_tpu/ops/raster_pallas.py:377",
         "launches": train_launches[1], "max_abs_err": bwd_err,
         "ms": t_bwd, "plain_ms": t_bwd_plain, "bound_ms": bwd_bound[0],
         "bound_by": bwd_bound[1], "library_ms": None}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
