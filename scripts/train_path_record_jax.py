"""Write the JAX package's record for the port's training-quality gate:
the final validation PSNR, SSIM and n_alive of
scripts/train_path_parity.py's golden route (`run_path(False, ...)`) at
one setting, with the commit and the command, as JSON.  It runs the JAX
package on the CPU and is not part of the PyTorch port;
scripts/train_path_parity_torch.py --against FILE reads the record.

At the default 64^2 / 300 iterations the densify window of the setting
(every 100 from iteration 500 to iters/2) never opens: the record covers
the optimizer and the renderer, not density control.

Usage:  python scripts/train_path_record_jax.py [--size 64] [--iters 300]
            [--out docs/artifacts/train_path_parity_jax.json]
        (the 256^2 record, about half an hour on a CPU host:
         --size 256 --out docs/artifacts/train_path_parity_jax_256.json)
"""

from __future__ import annotations

import argparse
import json
import platform
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DEFAULT_OUT = REPO / "docs" / "artifacts" / "train_path_parity_jax.json"
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--out", type=str, default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import train_path_parity

    # the defaults of train_path_parity.main's other flags
    run_args = argparse.Namespace(iters=args.iters, size=args.size,
                                  capacity=4096, max_instances=2 ** 17)
    command = ("python scripts/train_path_record_jax.py --size "
               f"{args.size} --iters {args.iters}")
    if Path(args.out).resolve() != DEFAULT_OUT.resolve():
        command += f" --out {args.out}"
    t0 = time.perf_counter()
    m = train_path_parity.run_path(False, run_args)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                            capture_output=True, text=True).stdout.strip()
    record = {
        "route": "golden (train_path_parity.run_path(False, ...))",
        "size": args.size, "iters": args.iters,
        "psnr": float(m["psnr"]), "ssim": float(m["ssim"]),
        "n_alive": int(m["n_alive"]),
        "train_seconds": float(m["seconds"]),
        "wall_seconds": time.perf_counter() - t0,
        "commit": commit or None,
        "command": command,
        "host": f"{platform.machine()} CPU, jax {jax.__version__}",
        "note": ("densify window (every 100 from iteration 500 to "
                 f"{args.iters // 2}) never opens" if args.iters // 2 < 500
                 else "densify every 100 from iteration 500 to "
                      f"{args.iters // 2}"),
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
