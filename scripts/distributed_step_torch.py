"""One process of a group that trains over the ranks of several processes
(the port's counterpart of the worker in tests/test_multiprocess.py).

Every process of the group runs this script with the same arguments:

    COORDINATOR_ADDRESS=127.0.0.1:PORT NUM_PROCESSES=2 PROCESS_ID=k \\
        python3 scripts/distributed_step_torch.py --device cpu --ranks 4 \\
        --out OUT

(or --coordinator / --num-processes / --process-id).  It joins the group
(parallel/distributed.py) and runs, each process over its own `--ranks`
ranks:

  collectives  all_to_all with unequal slices, a partial ppermute,
               all_gather and psum across the process boundary (the tile
               axis of the ring mesh, or with --no-ring of the row of the
               mesh that holds this process's first rank), against the
               single-process list versions under a seeded upstream
               gradient (forward bitwise, gradients within 1e-6
               relative); it raises otherwise;
  1  the replicated-state `make_sharded_train_step` over
     `make_global_mesh()`: data = the processes, tile = each one's ranks,
     band route (`--mesh D T` names another layout, say (2, 2) over four
     processes of one rank, whose rows and columns each cross two);
  2  that state split over the same mesh (`shard_train_state`), saved with
     `save_sharded_checkpoint` and restored (it raises unless the restored
     shards are bitwise the saved ones), then one gauss-sharded step;
  3  the band route and ring v1 over a (1, all ranks) mesh, so every ring
     hop crosses the processes (`--ring-ranks` ranks a process);
  4  ring v3 with the gauss-sharded state on that mesh;
  5  `make_sharded_render` and `make_gauss_sharded_render` of the setup's
     state under its first camera, over the mesh of 1 and 2 (band route)
     and over the ring mesh (band route and ring v1): every process that
     holds a rank gets the whole image, alpha and depth;
  6  `verify_shard_grad_parity` over the mesh of 1 and 2, both layouts;
  7  with `--partial D T`, one replicated step over the first D x T ranks
     (`make_global_mesh(D, T)`), which leaves the last processes without
     a rank: they take part in no exchange and get None.

`--ring-only` runs the collectives and programs 3, 4 and 5 (the ring
mesh's renders) alone, for a group whose data axis the setup's two cameras
do not fill; `--no-ring` leaves out the ring mesh and programs 3 and 4.

Without --setup the scene is the one of tests/test_multiprocess.py, made
here from seeds: 40 random Gaussians in 64 slots at 64x64 for programs 1
and 2, the same at 128x32 for 3 and 4, tile 16.  `--setup FILE` reads
another (`write_setup`).  Each step runs once for the results, then
`--steps` more times for the host ms.  The process writes its losses,
xyz and kernel launches to OUT/result.p<k>.pt, with `--record` the inputs
of its heaviest backward kernel launch without and with t0 to
OUT/kernels.p<k>.pt, and prints one JSON line.  Without a group it runs
the same programs in one process.

The program functions take a mesh, so a single-process caller runs them
over `make_mesh` for a reference (tests/test_torch_distributed.py,
chip_smoke.py phase 19).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import json
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mini3dgs_tpu_torch import convert  # noqa: E402
from mini3dgs_tpu_torch.config import TrainingConfig  # noqa: E402
from mini3dgs_tpu_torch.core.camera import Camera  # noqa: E402
from mini3dgs_tpu_torch.ops import raster_cuda as RC  # noqa: E402
from mini3dgs_tpu_torch.ops.renderer import RenderSettings  # noqa: E402
from mini3dgs_tpu_torch.parallel import distributed as D  # noqa: E402
from mini3dgs_tpu_torch.parallel import mesh as M  # noqa: E402
from mini3dgs_tpu_torch.parallel import sharded  # noqa: E402
from mini3dgs_tpu_torch.train import checkpoint  # noqa: E402
from mini3dgs_tpu_torch.train import trainer  # noqa: E402
from mini3dgs_tpu_torch.utils import profiling  # noqa: E402


# ---- the setup ------------------------------------------------------------

def random_scene(n: int, seed: int, spread: float, capacity: int):
    """tests/test_raster_pallas.random_scene in `capacity` slots, as numpy
    (params, alive): isotropic-ish axis-aligned splats with DC colours."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                          rng.uniform(0.5, 4.0, (n, 1))], axis=1)
    sig = rng.uniform(0.01, 0.12, (n, 3)).astype(np.float32)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    op = np.clip(rng.uniform(0.2, 0.95, n).astype(np.float32),
                 1e-6, 1 - 1e-6)
    p = dict(xyz=np.zeros((capacity, 3), np.float32),
             features_dc=np.zeros((capacity, 1, 3), np.float32),
             features_rest=np.zeros((capacity, 15, 3), np.float32),
             scaling=np.full((capacity, 3), -10.0, np.float32),
             rotation=np.tile(np.float32([1, 0, 0, 0]), (capacity, 1)),
             opacity=np.full((capacity, 1), -10.0, np.float32))
    p["xyz"][:n] = xyz
    p["features_dc"][:n, 0] = col
    p["scaling"][:n] = np.log(sig)
    p["opacity"][:n, 0] = np.log(op / (1 - op))
    alive = np.zeros(capacity, bool)
    alive[:n] = True
    return p, alive


def small_setup() -> dict:
    """The scene of tests/test_multiprocess.py (`write_setup`'s layout):
    programs 1 and 2 at 64x64 with the target of seed 7 on both cameras,
    programs 3 and 4 at 128x32 with the target of seed 8."""
    params, alive = random_scene(40, seed=2, spread=0.35, capacity=64)
    g = convert.gaussians_from_numpy(params, alive)

    def part(h, w, seed, n_cams):
        cfg = TrainingConfig(capacity=64, image_height=h, image_width=w,
                             tile_size=16)
        st = RenderSettings(image_height=h, image_width=w, tile_size=16)
        target = np.random.default_rng(seed).uniform(
            0, 1, (3, h, w)).astype(np.float32)
        fov = math.radians(70.0)
        cam = convert.camera_from_numpy(np.eye(3), np.zeros(3), fov, fov,
                                        width=w, height=h, image=target)
        return {"config": cfg, "settings": st,
                "state": trainer.create_train_state(g, cfg),
                "cameras": [cam] * n_cams}

    return {"mesh": part(64, 64, 7, 2), "ring": part(128, 32, 8, 1)}


def _camera_dict(c: Camera) -> dict:
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


def write_setup(path, setup: dict) -> None:
    """Save a setup: for "mesh" (programs 1, 2) and "ring" (3, 4) the
    TrainingConfig, RenderSettings, TrainState and cameras ("mesh": one a
    data rank of the global mesh; "ring": one)."""
    blob = {}
    for key, part in setup.items():
        blob[key] = {
            "config": dataclasses.asdict(part["config"]),
            "settings": dataclasses.asdict(part["settings"]),
            "state": checkpoint._blob(part["state"]),
            "cameras": [_camera_dict(c) for c in part["cameras"]]}
    torch.save(blob, path)


def read_setup(path, device) -> dict:
    """`write_setup`'s setup with its tensors on `device`."""
    blob = torch.load(path, map_location=device, weights_only=True)
    out = {}
    for key, part in blob.items():
        st = dict(part["settings"])
        st["bg_color"] = tuple(st["bg_color"])
        out[key] = {"config": TrainingConfig(**part["config"]),
                    "settings": RenderSettings(**st),
                    "state": checkpoint._state(part["state"]),
                    "cameras": [Camera(**c) for c in part["cameras"]]}
    return out


def setup_on(setup: dict, device) -> dict:
    """The setup with its state and cameras on `device`."""
    return {key: {**part,
                  "cameras": [c.to(device) for c in part["cameras"]],
                  "state": checkpoint._state(checkpoint._to_device(
                      checkpoint._blob(part["state"]), device))}
            for key, part in setup.items()}


# ---- measuring --------------------------------------------------------------

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


LAUNCHES = ("raster_fwd.launches", "raster_bwd.launches",
            "raster_fwd.launches_t0", "raster_bwd.launches_t0")


def run_step(step, args, device, steps: int) -> dict:
    """step(*args) once for the result, with the kernels' launches and the
    bytes it put through torch.distributed (the stage recorder's counters
    of that step); then `steps` more times for the host ms, and the host
    ms of those spent in torch.distributed (each from the same inputs)."""
    _sync(device)
    with profiling.recording(device) as rec:
        t0 = time.perf_counter()
        out, metrics = step(*args)
        _sync(device)
        first_ms = (time.perf_counter() - t0) * 1e3
    c = rec.counters(1)
    res = {"out": out, "metrics": metrics,
           "loss": float(metrics["total_loss"]),
           "launches": [int(c[k]) for k in LAUNCHES],
           "bytes": int(c["traffic.bytes"]), "calls": int(c["traffic.calls"]),
           "first_ms": first_ms, "step_ms": [], "exchange_ms": []}
    for _ in range(steps):
        _sync(device)
        in_dist = M.TRAFFIC["seconds"]
        t0 = time.perf_counter()
        step(*args)
        _sync(device)
        res["step_ms"].append((time.perf_counter() - t0) * 1e3)
        res["exchange_ms"].append((M.TRAFFIC["seconds"] - in_dist) * 1e3)
    if res["step_ms"]:
        res["step_ms_median"] = statistics.median(res["step_ms"])
        res["exchange_ms_median"] = statistics.median(res["exchange_ms"])
    return res


@contextlib.contextmanager
def recording(keep: dict):
    """Keep in `keep` the arguments of the heaviest `raster_bwd` launch on
    the card, without ("bwd") and with ("bwd_t0") the incoming
    transmittance, while the block runs.  The wrapper stands in for the
    module's function."""
    orig = RC.raster_bwd
    names = list(inspect.signature(orig).parameters)

    def wrapped(*a, **k):
        out = orig(*a, **k)
        call = {n: v.detach() if torch.is_tensor(v) else v
                for n, v in dict(zip(names, a), **k).items()}
        if call["stream"].is_cuda:
            key = "bwd" if call.get("t0") is None else "bwd_t0"
            if key not in keep or call["stream"].shape[1] \
                    > keep[key]["stream"].shape[1]:
                keep[key] = call
        return out

    RC.raster_bwd = wrapped
    try:
        yield
    finally:
        RC.raster_bwd = orig


# ---- the programs -----------------------------------------------------------

def check_collectives(mesh: M.Mesh, seed: int = 0) -> dict:
    """The collectives over the tile axis of `mesh` that holds this
    process's first rank, against their single-process
    list versions on this process's first device, under a seeded upstream
    gradient: all_to_all of unequal slices, ppermute (a partial
    permutation), all_gather and psum.  Forward bitwise; gradients bitwise
    or within 1e-6 relative.  Every process differentiates one copy of the
    sum, as a step differentiates its loss, and the reference the copy of
    rank 0.  Raises otherwise; returns the worst relative gradient
    error."""
    devices = mesh.tile_devices(mesh.local_ranks()[0] // mesh.tile)
    n, mine = len(devices), M.local_ranks(devices)
    single = [devices[mine[0]]] * n
    g = torch.Generator().manual_seed(seed)
    dev = single[0]
    rand = lambda *shape: torch.randn(*shape, generator=g).to(dev)
    worst, fwd_ok = 0.0, True

    def run(name, inputs, fn, ups, one_copy=False):
        """inputs: a list per rank of lists of tensors."""
        nonlocal worst, fwd_ok
        leaves = lambda keep: [[x.clone().requires_grad_(True) for x in xs]
                               if keep(r) else None
                               for r, xs in enumerate(inputs)]
        ref_in = leaves(lambda r: True)
        ref = fn(ref_in, single)
        got_in = leaves(lambda r: r in mine)
        got = fn(got_in, devices)
        for d in mine:
            fwd_ok &= all(torch.equal(a, b)
                          for a, b in zip(got[d], ref[d]))
        flat_in = lambda xs, rs: [x for r in rs for x in xs[r]]
        loss = lambda out, rs: sum((o * u).sum() for r in rs
                                   for o, u in zip(out[r], ups[r]))
        g_ref = torch.autograd.grad(
            loss(ref, [0] if one_copy else range(n)),
            flat_in(ref_in, range(n)), allow_unused=True)
        g_got = torch.autograd.grad(
            loss(got, mine[:1] if one_copy else mine),
            flat_in(got_in, mine) + [M.ANCHOR], allow_unused=True)[:-1]
        per = len(inputs[0])
        for k, r in enumerate(mine):
            for j in range(per):
                a, b = g_got[k * per + j], g_ref[r * per + j]
                if a is None and b is None:
                    continue
                err = float((a - b).abs().max() / b.abs().max().clamp(
                    min=1e-30))
                worst = max(worst, err)
        if not fwd_ok or worst > 1e-6:
            raise AssertionError(f"collective {name}: forward bitwise "
                                 f"{fwd_ok}, gradient error {worst:.3e}")

    # all_to_all: rank r sends r + d + 1 rows to rank d
    sizes = [[r + d + 1 for d in range(n)] for r in range(n)]
    run("all_to_all", [[rand(sizes[r][d], 3) for d in range(n)]
                       for r in range(n)],
        lambda xs, devs: M.all_to_all(xs, devs),
        [[rand(sizes[r][d], 3) for r in range(n)] for d in range(n)])
    perm = [(i, i + 1) for i in range(n - 1)]
    run("ppermute", [[rand(4, 2)] for _ in range(n)],
        lambda xs, devs: [None if x is None else [x] for x in M.ppermute(
            [None if x is None else x[0] for x in xs], perm, devs)],
        [[rand(4, 2)] for _ in range(n)])
    run("all_gather", [[rand(2 + r, 3)] for r in range(n)],
        lambda xs, devs: [None if x is None else [x] for x in M.all_gather(
            [None if x is None else x[0] for x in xs], devs)],
        [[rand(sum(2 + r for r in range(n)), 3)] for _ in range(n)])
    run("psum", [[rand(3)] for _ in range(n)],
        lambda xs, devs: [None if x is None else [x] for x in M.psum(
            [None if x is None else x[0] for x in xs], devs)],
        [[rand(3)]] * n, one_copy=True)
    return {"forward_bitwise": fwd_ok, "grad_rel_max": worst}


def replicated_step(part: dict, mesh: M.Mesh, steps: int = 0,
                    ring: bool = False) -> dict:
    """Program 1 (and 3's steps): one replicated-state train step over
    `mesh` from the part's state, with the cameras one a data rank."""
    st = part["settings"].replace(ring=ring)
    step = sharded.make_sharded_train_step(part["config"], st, mesh)
    res = run_step(step, (part["state"], part["cameras"][:mesh.data]),
                   part["state"].gaussians.device, steps)
    res["xyz"] = res.pop("out").gaussians.xyz
    return res


def gauss_sharded_step(part: dict, mesh: M.Mesh, steps: int = 0,
                       ring_local: bool = False) -> dict:
    """Program 2's step and program 4: one gauss-sharded train step over
    `mesh` (ring v3 with `ring_local`); `xyz` is the gathered pool's."""
    st = part["settings"].replace(ring=ring_local, ring_local=ring_local)
    cfg = dataclasses.replace(part["config"], shard_gauss_state=True)
    split = sharded.shard_train_state(part["state"], mesh)
    step = sharded.make_gauss_sharded_train_step(cfg, st, mesh)
    res = run_step(step, (split, part["cameras"][:mesh.data]),
                   part["state"].gaussians.device, steps)
    res["xyz"] = sharded.gather_train_state(res.pop("out"), mesh) \
        .gaussians.xyz
    res["reshard_drops"] = float(res["metrics"].get("reshard_drops", 0))
    return res


def renders(part: dict, mesh: M.Mesh, ring: bool = False) -> dict:
    """Program 5: the part's state under its first camera through
    `make_sharded_render` ("replicated") and `make_gauss_sharded_render`
    ("gauss_sharded") over `mesh`, each as [image; alpha; depth] [5, H, W]
    on the host (None on a process without a rank), with the ring route's
    `ring`."""
    st = part["settings"].replace(ring=ring)
    g, cam = part["state"].gaussians, part["cameras"][0]
    split = sharded.shard_train_state(part["state"], mesh)
    outs = {
        "replicated": sharded.make_sharded_render(st, mesh)(g, cam),
        "gauss_sharded": sharded.make_gauss_sharded_render(st, mesh)(
            [None if s is None else s.gaussians for s in split.shards],
            cam)}
    return {k: None if o is None else torch.cat(
        [o["image"], o["alpha"], o["depth"]]).cpu() for k, o in outs.items()}


def grad_parity(part: dict, mesh: M.Mesh) -> dict:
    """Program 6: `verify_shard_grad_parity` over `mesh` in both layouts,
    the worst deviations (None on a process without a rank)."""
    return {layout: sharded.verify_shard_grad_parity(
        part["config"], mesh, gauss_sharded=layout == "gauss_sharded")
        for layout in ("replicated", "gauss_sharded")}


def checkpoint_round_trip(part: dict, mesh: M.Mesh, out_dir) -> bool:
    """Program 2's checkpoint: the state split over `mesh`, saved by every
    process and restored into a template of the same layout; True when
    every restored shard is bitwise the saved one."""
    split = sharded.shard_train_state(part["state"], mesh)
    checkpoint.save_sharded_checkpoint(out_dir, 1, split, mesh)
    template = sharded.shard_train_state(part["state"], mesh)
    restored, _ = checkpoint.load_sharded_checkpoint(out_dir, 1, template,
                                                     mesh)
    same = lambda a, b: a.dtype == b.dtype and a.device == b.device \
        and torch.equal(a, b)
    ok = True
    for a, b in zip(split.shards, restored.shards):
        if a is None or b is None:
            ok &= a is None and b is None
            continue
        ok &= a.step == b.step
        for f in dataclasses.fields(a.gaussians):
            ok &= same(getattr(a.gaussians, f.name),
                       getattr(b.gaussians, f.name))
        for slot in ("mu", "nu"):
            for k, v in getattr(a.opt_state, slot).items():
                ok &= same(v, getattr(b.opt_state, slot)[k])
    return bool(ok)


def summary(res: dict) -> dict:
    keys = ("loss", "launches", "bytes", "calls", "first_ms", "step_ms",
            "step_ms_median", "exchange_ms_median", "reshard_drops")
    return {k: res[k] for k in keys if k in res}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=4,
                    help="ranks a process for programs 1 and 2")
    ap.add_argument("--ring-ranks", type=int, default=None,
                    help="ranks a process for programs 3 and 4 "
                    "(default --ranks)")
    ap.add_argument("--setup", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=0,
                    help="timed steps after the first of each program")
    ap.add_argument("--record", action="store_true")
    ap.add_argument("--ring-only", action="store_true",
                    help="the collectives and programs 3, 4 and 5 only")
    ap.add_argument("--no-ring", action="store_true",
                    help="leave out the ring mesh and programs 3 and 4")
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("DATA", "TILE"),
                    help="the mesh of programs 1, 2, 5 and 6 (default: "
                    "the processes by each one's ranks)")
    ap.add_argument("--partial", type=int, nargs=2, default=None,
                    metavar=("DATA", "TILE"),
                    help="program 7's mesh of the first DATA x TILE ranks")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args()
    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(1)
    device = torch.device(args.device)
    # CPU ranks take gloo; ranks on cards NCCL unless the caller says gloo
    # (several processes on one card)
    D.initialize_distributed(
        args.coordinator, args.num_processes, args.process_id,
        backend=args.backend or ("gloo" if device.type == "cpu" else None),
        timeout=args.timeout)
    me = D.process_index()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    setup = setup_on(read_setup(args.setup, "cpu") if args.setup
                     else small_setup(), device)
    t_start = time.perf_counter()

    mesh = None if args.ring_only else D.make_global_mesh(
        *(args.mesh or (None, None)), local_devices=[device] * args.ranks)
    ring_mesh = None if args.no_ring else D.make_global_mesh(
        data=1, tile=D.process_count() * (args.ring_ranks or args.ranks),
        local_devices=[device] * (args.ring_ranks or args.ranks))
    report = {"process": me, "processes": D.process_count(),
              "device": str(device),
              "mesh": None if mesh is None else [mesh.data, mesh.tile],
              "groups": None if mesh is None
              else sorted(list(k) for k in M.form_groups(mesh)),
              "ring_mesh": None if ring_mesh is None
              else [ring_mesh.data, ring_mesh.tile]}
    report["collectives"] = check_collectives(ring_mesh or mesh, seed=10)
    keep, results = {}, {}
    with recording(keep) if args.record else contextlib.nullcontext():
        if mesh is not None:
            p1 = replicated_step(setup["mesh"], mesh, args.steps)
            results["p1_xyz"] = p1["xyz"]
            report["p1"] = summary(p1)
            report["p2_checkpoint_bitwise"] = checkpoint_round_trip(
                setup["mesh"], mesh, out / "ckpt")
            if not report["p2_checkpoint_bitwise"]:
                raise AssertionError("the restored shards differ from the "
                                     "saved ones")
            p2 = gauss_sharded_step(setup["mesh"], mesh, args.steps)
            results["p2_xyz"] = p2["xyz"]
            report["p2"] = summary(p2)
            results["p5_mesh"] = renders(setup["mesh"], mesh)
            report["p6"] = grad_parity(setup["mesh"], mesh)
        if ring_mesh is not None:
            for name, ring in (("p3_band", False), ("p3_ring", True)):
                r = replicated_step(setup["ring"], ring_mesh, args.steps,
                                    ring)
                results[name + "_xyz"] = r["xyz"]
                report[name] = summary(r)
            p4 = gauss_sharded_step(setup["ring"], ring_mesh, args.steps,
                                    True)
            results["p4_xyz"] = p4["xyz"]
            report["p4"] = summary(p4)
            for ring in (False, True):
                results[f"p5_ring_mesh_{'ring' if ring else 'band'}"] = \
                    renders(setup["ring"], ring_mesh, ring)
        if args.partial is not None:
            part = D.make_global_mesh(*args.partial,
                                      local_devices=[device] * args.ranks)
            report["p7_mesh"] = [part.data, part.tile]
            report["p7_ranks"] = part.local_ranks()
            if part.local_ranks():
                p7 = replicated_step(setup["mesh"], part, args.steps)
                results["p7_xyz"] = p7["xyz"]
                report["p7"] = summary(p7)
            else:
                step = sharded.make_sharded_train_step(
                    setup["mesh"]["config"], setup["mesh"]["settings"], part)
                if step(setup["mesh"]["state"],
                        setup["mesh"]["cameras"][:part.data]) != (None, None):
                    raise AssertionError("a process without a rank got a "
                                         "result")
                results["p7_xyz"] = report["p7"] = None
    results["losses"] = {k: report[k]["loss"] for k in
                         ("p1", "p2", "p3_band", "p3_ring", "p4", "p7")
                         if report.get(k) is not None}
    torch.save({k: v.cpu() if torch.is_tensor(v) else v
                for k, v in results.items()}, out / f"result.p{me}.pt")
    if args.record:
        torch.save({key: {k: v.cpu() if torch.is_tensor(v) else v
                          for k, v in call.items()}
                    for key, call in keep.items()},
                   out / f"kernels.p{me}.pt")
        report["recorded"] = {k: int(v["stream"].shape[1])
                              for k, v in keep.items()}
    report["seconds"] = time.perf_counter() - t_start
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
