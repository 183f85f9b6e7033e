"""Write the JAX package's record of `__graft_entry__.dryrun_multichip(n)`:
the loss of each of its six train steps at full precision, with the mesh,
the commit and the command, as JSON.  It runs the JAX package on the CPU
(n virtual devices) and is not part of the PyTorch port;
tests/test_torch_graft_entry.py holds `graft_entry_torch.dryrun_multichip`
against the record.

The dryrun itself runs unchanged: the step factories it imports from
`mini3dgs_tpu.parallel.sharded` are wrapped, in this process only, so that
each step's metrics are kept as it returns them.  The six steps, in the
dryrun's order: the replicated step, the gauss-sharded step, ring v1, ring
v2 (`ring_reshard`), and the gauss-sharded ring steps without and with
`ring_local` (ring v3); the ring steps run when the tile axis has more than
one rank.

Usage:  python scripts/dryrun_record_jax.py [--devices 8]
            [--out docs/artifacts/dryrun_multichip_jax.json]
        (about a minute and a half on a CPU host at 8 devices)
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DEFAULT_OUT = REPO / "docs" / "artifacts" / "dryrun_multichip_jax.json"
sys.path.insert(0, str(REPO))
STEPS = ("replicated", "gauss_sharded", "ring_v1", "ring_v2",
         "gauss_sharded_ring_v1", "gauss_sharded_ring_v3")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--out", type=str, default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count="
            f"{args.devices}").strip()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import __graft_entry__
    from mini3dgs_tpu.parallel import sharded

    losses = []

    def keeping(factory):
        def make(*a, **k):
            step = factory(*a, **k)

            def run(*sa, **sk):
                out = step(*sa, **sk)
                losses.append(float(out[1]["total_loss"]))
                return out
            return run
        return make

    for name in ("make_sharded_train_step", "make_gauss_sharded_train_step"):
        setattr(sharded, name, keeping(getattr(sharded, name)))
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        __graft_entry__.dryrun_multichip(args.devices)
    seconds = time.perf_counter() - t0
    command = f"python scripts/dryrun_record_jax.py --devices {args.devices}"
    if Path(args.out).resolve() != DEFAULT_OUT.resolve():
        command += f" --out {args.out}"
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                            capture_output=True, text=True).stdout.strip()
    record = {
        "function": "__graft_entry__.dryrun_multichip",
        "devices": args.devices,
        "losses": dict(zip(STEPS, losses)),
        "printed": printed.getvalue().strip(),
        "seconds": seconds,
        "backend": jax.default_backend(), "jax": jax.__version__,
        "python": platform.python_version(), "commit": commit,
        "command": command}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
