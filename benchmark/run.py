"""One run of one cell of the benchmark of mini3dgs_tpu_torch, the PyTorch
and CUDA 3D Gaussian Splatting package, on the cards of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout.  The cell (BENCHMARK.json) names its
configuration, traffic mix and metrics; their files are found by name
under this folder.  The run makes its inputs from the seed, sets up and
warms up (`setup_s`), measures for `--seconds`, with `--trace 1` profiles a
few more steps for the per-layer metrics, frees the program's state, then
compares what the timed path produced with the plain reference.  Its last
line on standard output is one JSON object; the numbers compared, each
beside its limit, are the last lines on standard error.  Without a CUDA
card, or with a JAX module loaded, it prints no result and exits 1.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _paths() -> None:
    for p in (str(BENCH), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """Run the cell once on `device`; returns the result object, with the
    numbers compared under its last key, "checks"."""
    import torch
    from harness import check, env

    out_dir = ROOT / "build" / "benchmark_out"
    drv = cell.driver(cell, seed, device, out_dir)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    win = drv.window(seconds)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": {}, "device": dev}
    if trace:
        ctx = drv.trace()
        for m in cell.per_layer:
            value = cell.readers[m["name"]](ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": units[m["name"]]}
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops,
                               "idle_gaps": ctx.trace.idle_gaps}
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
    if cuda:
        print(f"host: {env.host_launch_us(device):.3f} us a launch; card: "
              f"{env.card_state(device.index or 0)}; window "
              f"{win['window_s']:.3f} s, {win['attempted']} steps or "
              f"frames; setup {setup_s:.3f} s", file=sys.stderr, flush=True)
    drv.release()
    print(f"scene: {drv.scene_line()}", file=sys.stderr, flush=True)
    t_ref = time.perf_counter()
    numbers = drv.numbers(drv.reference())
    print(f"reference: {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr, flush=True)
    correct, checks = check.judge(numbers, cell.limits)
    result["correct"] = correct and win["failed"] == 0
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    from harness import env
    env.set_cache_dirs(ROOT)
    from harness.spec import load_cell
    import torch

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    result = run(cell, args.seed, args.seconds, bool(args.trace), device,
                 T_START)
    found = env.loaded()
    if found:
        print(f"modules of JAX or of the JAX package loaded: {found}",
              file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
