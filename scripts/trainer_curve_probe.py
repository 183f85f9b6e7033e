"""Loss curves and densify counts of the JAX package's and the port's
`GaussianTrainer` on one texture scene, on the CPU.

The texture scene of configs/sdf_tex_30k.yaml is made at --size^2 by the
port's generator (scripts/make_synthetic_scene_torch.py --texture, the JAX
script's scene; tests/test_torch_synthetic.py holds them together) and
exported once as a COLMAP model (scripts/export_colmap_scene_torch.py);
both trainers read those files.  Each runs the first --iters iterations of
the 30k schedule (the yaml's learning rates, densify every 100 from 500,
SH bands every 1000) with the yaml's rendering at --size^2: JAX through
its golden route (`use_pallas: false`), the port through its tile route
(on the CPU the kernels' plain versions).  The pool starts at --capacity
(the yaml's 2^19 slots cut to the next power of two over the cloud's
30,000 points: every per-Gaussian stage of the golden route is dense over
the pool) and grows as the trainers grow it.

Recorded: the training loss every --log-interval iterations, each densify
event's counts (clone, split, pruned, n_alive) and the final validation
PSNR / SSIM, as JSON at --out, with `first_parting`: the first logged
iteration where the losses differ by more than --loss-rtol or a densify
event's n_alive by more than --alive-rtol (null if none), and what parted
there.  It imports both packages, as the tests do; it is not a test.

Usage:  python scripts/trainer_curve_probe.py [--size 64] [--iters 1000]
            [--out docs/artifacts/trainer_curve_probe_64.json]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import io
import json
import platform
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
CONFIG = REPO / "configs" / "sdf_tex_30k.yaml"
DENSIFY_KEYS = ("n_clone", "n_split", "n_pruned", "n_alive")


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_scene(root: Path, size: int, n_train: int, n_test: int) -> Path:
    """The texture scene at size^2 as a COLMAP model; returns its dir."""
    scene, colmap_dir = root / "scene", root / "colmap"
    gen = _script("make_synthetic_scene_torch")
    with contextlib.redirect_stdout(io.StringIO()):
        gen.main(["--texture", "--out", str(scene), "--n-train",
                  str(n_train), "--n-test", str(n_test), "--size", str(size),
                  "--spp", "2", "--device", "cpu"])
        gen.main(["--texture", "--points-only", "--out", str(scene)])
        _script("export_colmap_scene_torch").main(
            ["--src", str(scene), "--out", str(colmap_dir)])
    return colmap_dir


def overrides(args, data: Path, out: Path) -> dict:
    """What both trainers change in the yaml's config."""
    return dict(data_path=str(data), output_path=str(out),
                iterations=args.iters, log_interval=args.log_interval,
                eval_interval=10 ** 9, save_interval=10 ** 9,
                capacity=args.capacity)


def run(package: str, args, data: Path, out: Path) -> dict:
    """One trainer over the schedule; its log, densify events, result."""
    if package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from mini3dgs_tpu.config import ConfigManager
        from mini3dgs_tpu.train.trainer import GaussianTrainer
        cfg = dataclasses.replace(
            ConfigManager.load_from_yaml(str(CONFIG)),
            **overrides(args, data, out), use_pallas=False,
            verify_sharding=False)
    else:
        import torch
        from mini3dgs_tpu_torch.config import ConfigManager
        from mini3dgs_tpu_torch.train.trainer import GaussianTrainer
        torch.set_num_threads(args.threads)
        cfg = dataclasses.replace(
            ConfigManager.load_from_yaml(str(CONFIG)),
            **overrides(args, data, out), use_pallas=True, device="cpu")
    tr = GaussianTrainer(cfg)
    tr.setup()
    loss, events = {}, {}
    t0 = time.perf_counter()

    def log_fn(it, m):
        loss[it] = float(m["total_loss"])
        if "n_clone" in m:
            events[it] = {k: int(m[k]) for k in DENSIFY_KEYS}
        print(f"  [{package} {it:5d}] loss={loss[it]:.6f} "
              f"({time.perf_counter() - t0:.1f} s)"
              + (f" {events[it]}" if it in events else ""), flush=True)

    t0 = time.perf_counter()
    tr.train(log_fn=log_fn)
    seconds = time.perf_counter() - t0
    m = tr.validate()
    return {"loss": loss, "densify": events,
            "psnr": float(m["psnr"]), "ssim": float(m["ssim"]),
            "n_alive": int(tr.state.gaussians.num_alive()),
            "capacity": int(tr.state.gaussians.capacity),
            "n_train": len(tr.dataset.get_train_cameras()),
            "n_test": len(tr.dataset.get_test_cameras()),
            "train_seconds": seconds}


def first_parting(jr: dict, pr: dict, loss_rtol: float,
                  alive_rtol: float):
    """The first logged iteration where the two runs part, and how."""
    for it in sorted(set(jr["loss"]) | set(jr["densify"])):
        lj, lp = jr["loss"].get(it), pr["loss"].get(it)
        if lj is not None and lp is not None and abs(lp / lj - 1) > loss_rtol:
            return {"iteration": it, "what": "loss", "jax": lj, "port": lp,
                    "rel": lp / lj - 1}
        ej, ep = jr["densify"].get(it), pr["densify"].get(it)
        if (ej is None) != (ep is None):
            return {"iteration": it, "what": "densify event", "jax": ej,
                    "port": ep}
        if ej is not None and abs(ep["n_alive"] / ej["n_alive"] - 1) \
                > alive_rtol:
            return {"iteration": it, "what": "n_alive", "jax": ej,
                    "port": ep, "rel": ep["n_alive"] / ej["n_alive"] - 1}
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--log-interval", type=int, default=100)
    ap.add_argument("--capacity", type=int, default=2 ** 15)
    ap.add_argument("--n-train", type=int, default=16)
    ap.add_argument("--n-test", type=int, default=2)
    ap.add_argument("--threads", type=int, default=4,
                    help="torch threads of the port's run")
    ap.add_argument("--loss-rtol", type=float, default=0.05)
    ap.add_argument("--alive-rtol", type=float, default=0.05)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    out = Path(args.out or REPO / "docs" / "artifacts"
               / f"trainer_curve_probe_{args.size}.json")

    with tempfile.TemporaryDirectory(prefix="curve_probe_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        data = make_scene(root, args.size, args.n_train, args.n_test)
        print(f"texture scene at {args.size}^2 in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        res = {p: run(p, args, data, root / p) for p in ("jax", "port")}
    import jax
    import torch
    parting = first_parting(res["jax"], res["port"], args.loss_rtol,
                            args.alive_rtol)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                            capture_output=True, text=True).stdout.strip()
    record = {
        "setting": (f"configs/sdf_tex_30k.yaml's schedule, first "
                    f"{args.iters} iterations, texture scene at "
                    f"{args.size}^2 ({args.n_train} train + {args.n_test} "
                    f"test views made, COLMAP every-8th hold-out), pool "
                    f"from {args.capacity}; JAX golden route, port tile "
                    f"route (plain versions)"),
        "size": args.size, "iters": args.iters,
        "loss_rtol": args.loss_rtol, "alive_rtol": args.alive_rtol,
        "jax": res["jax"], "port": res["port"],
        "first_parting": parting,
        "commit": commit or None,
        "command": " ".join(["python scripts/trainer_curve_probe.py",
                             *(argv if argv is not None else sys.argv[1:])]),
        "host": (f"{platform.machine()} CPU, jax {jax.__version__}, "
                 f"torch {torch.__version__}"),
    }
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps({"first_parting": parting,
                      "psnr": {p: res[p]["psnr"] for p in res},
                      "n_alive": {p: res[p]["n_alive"] for p in res}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
