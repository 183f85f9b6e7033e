"""Driver entry points of the PyTorch/CUDA port (counterpart of
__graft_entry__.py).

entry()             -> (fn, example_args): a forward render of the flagship
                       Gaussian scene at 256x256 through the raster kernels,
                       on the card (the compile-and-launch check of one card).
dryrun_multichip(n) -> builds an n-rank (data x tile) mesh, runs ONE step of
                       each sharded train step on tiny shapes (the replicated
                       and the gauss-sharded state, the band route, ring v1,
                       ring v2, and the gauss-sharded ring without and with
                       `ring_local`: ring v3), checks their losses against
                       each other, prints the JAX dryrun's line and returns
                       the losses.

Both run on the card unless the caller passes device="cpu"; the n ranks of
the dryrun share the one card (or the CPU), as the JAX dryrun's virtual CPU
devices share the host.

Usage:  python3 graft_entry_torch.py    (entry() on the card; prints
                                         "entry OK: <shape> <mean>")
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# The losses of `dryrun_multichip`, in the order it takes the steps.
STEPS = ("replicated", "gauss_sharded", "ring_v1", "ring_v2",
         "gauss_sharded_ring_v1", "gauss_sharded_ring_v3")


def _device(device) -> torch.device:
    """The card unless the caller names a device; without a card that is
    an error, never a fallback to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("graft_entry_torch: no CUDA device is visible; "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


def _scene(capacity: int, n: int, width: int, height: int, device,
           image=None):
    """`__graft_entry__._scene` on `device`: (Gaussians, Camera)."""
    from mini3dgs_tpu_torch import convert

    params, alive, cam = convert.flagship_scene_numpy(capacity, n)
    return (convert.gaussians_from_numpy(params, alive, device),
            convert.camera_from_numpy(**cam, width=width, height=height,
                                      device=device, image=image))


def entry(device=None):
    """(fn, (gaussians, camera)): fn renders the flagship scene (2,048
    slots, 1,024 Gaussians) at 256x256 through the tile kernels and
    returns the image [3, 256, 256]."""
    from mini3dgs_tpu_torch.ops.renderer import RenderSettings, render

    dev = _device(device)
    g, cam = _scene(2048, 1024, 256, 256, dev)
    settings = RenderSettings(image_height=256, image_width=256)

    def fn(gaussians, camera):
        return render(gaussians, camera, settings)["image"]

    return fn, (g, cam)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One step of each sharded train step over a (data, tile) mesh of
    `n_devices` ranks, factored as the JAX dryrun factors it (tile the
    largest of 4, 3, 2, 1 that divides n), at its tiny shapes: 128
    Gaussians in 256 slots, H = W = 32 * tile (two 16-pixel tile rows a
    band), a black target on every data rank's camera.  Asserts what the
    JAX dryrun asserts: every loss finite, ring v1 within 1e-4 of the band
    route, ring v2 within 1e-5 of ring v1, both gauss-sharded ring steps
    within 1e-4 of the gauss-sharded band step.  Returns {step: loss}
    (`STEPS`; the ring steps only when tile > 1)."""
    from mini3dgs_tpu_torch.config import TrainingConfig
    from mini3dgs_tpu_torch.ops.renderer import RenderSettings
    from mini3dgs_tpu_torch.parallel.mesh import make_mesh
    from mini3dgs_tpu_torch.parallel.sharded import (
        make_gauss_sharded_train_step, make_sharded_train_step,
        shard_train_state)
    from mini3dgs_tpu_torch.train.trainer import create_train_state

    dev = _device(device)
    tile = next(t for t in range(min(4, n_devices), 0, -1)
                if n_devices % t == 0)
    data = n_devices // tile
    H = W = 16 * tile * 2
    cfg = TrainingConfig(capacity=256, image_height=H, image_width=W,
                         mesh_data=data, mesh_tile=tile)
    settings = RenderSettings(image_height=H, image_width=W)
    mesh = make_mesh(data=data, tile=tile, devices=[dev])
    target = np.zeros((3, H, W), np.float32)

    def run(gauss_sharded: bool, st: RenderSettings) -> float:
        g, cam = _scene(256, 128, W, H, dev, image=target)
        state = create_train_state(g, cfg)
        if gauss_sharded:
            step = make_gauss_sharded_train_step(
                dataclasses.replace(cfg, shard_gauss_state=True), st, mesh)
            state = shard_train_state(state, mesh)
        else:
            step = make_sharded_train_step(cfg, st, mesh)
        _, metrics = step(state, [cam] * data)
        loss = float(metrics["total_loss"])
        assert np.isfinite(loss), f"a non-finite loss: {loss}"
        return loss

    losses = {"replicated": run(False, settings),
              "gauss_sharded": run(True, settings)}
    if tile > 1:
        ring = settings.replace(ring=True)
        losses["ring_v1"] = run(False, ring)
        assert abs(losses["ring_v1"] - losses["replicated"]) < 1e-4, (
            "ring-exchange loss must match the all_to_all route")
        losses["ring_v2"] = run(False, ring.replace(ring_reshard=True))
        assert abs(losses["ring_v2"] - losses["ring_v1"]) < 1e-5, (
            "rank-resharded ring loss must match ring v1")
        for ring_local, key in ((False, "gauss_sharded_ring_v1"),
                                (True, "gauss_sharded_ring_v3")):
            losses[key] = run(True, ring.replace(ring_local=ring_local))
            assert abs(losses[key] - losses["gauss_sharded"]) < 1e-4, (
                f"gauss-sharded ring (local={ring_local}) loss must match "
                f"the gauss-sharded all_to_all route")
    print(f"dryrun_multichip OK: mesh=(data={data}, tile={tile}) "
          f"loss={losses['replicated']:.4f} "
          f"gauss-sharded loss={losses['gauss_sharded']:.4f} "
          f"ring loss={losses.get('ring_v1', losses['replicated']):.4f}")
    return losses


def main(device: Optional[str] = None) -> int:
    fn, args = entry(device)
    out = fn(*args)
    if out.is_cuda:
        torch.cuda.synchronize()
    print("entry OK:", tuple(out.shape), float(out.mean()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
