"""Training configuration (counterpart of mini3dgs_tpu/config.py).

The flat `TrainingConfig` dataclass with the JAX package's field names and
defaults, so a configuration reads the same in both packages.  Left out
are the fields that size the JAX package's static shapes or select its
kernels (max_instances, gaussian_chunk, ring_capacity, use_pallas, ...) and
the knobs of mesh routes not ported yet (ring_reshard, ring_local,
shard_gauss_state): the port's stream holds exactly the live instances, and
the raster path is `RenderSettings.raster`.  Also left out, until the code
that reads them is ported (the dataset loaders, `GaussianTrainer`, the
YAML loader): the data paths, batch_size, the eval and save intervals,
radius_min, radius_max, antialias, device and seed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class TrainingConfig:
    # -- training --
    iterations: int = 30000
    log_interval: int = 100

    # -- per-group learning rates --
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_steps: int = 0
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30000
    # Canonical 3DGS scales the position LR by the scene extent, so
    # position steps are proportional to scene size.
    scale_position_lr_by_extent: bool = True
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001

    # -- density control --
    densify_from_iter: int = 500
    densify_until_iter: int = 15000
    densify_grad_threshold: float = 0.0002
    densify_interval: int = 100
    prune_opacity_threshold: float = 0.005
    prune_interval: int = 1000
    opacity_reset_interval: int = 3000
    percent_dense_split: float = 0.03   # split if mean sigma > 0.03 * extent
    percent_dense_clone: float = 0.01   # clone if mean sigma < 0.01 * extent
    # Big-point prunes applied at densify events once iteration >
    # opacity_reset_interval: screen size (window max 2D radius, pixels)
    # and world size (max sigma as a fraction of the extent).  0 disables.
    prune_max_screen_size: float = 20.0
    prune_max_world_size: float = 0.1
    # "viewspace": ||dL/d means2D|| in NDC units (what the 2e-4 threshold
    # is calibrated for); "world": ||dL/d xyz||.
    densify_grad_space: str = "viewspace"

    # -- rendering --
    image_height: int = 800
    image_width: int = 800
    background_color: List[float] = field(
        default_factory=lambda: [0.0, 0.0, 0.0])
    tile_size: int = 16
    sh_degree: int = 3
    color_mode: str = "dc_sigmoid"
    sh_increase_interval: int = 1000  # progressive SH degree unlock

    # -- loss --
    lambda_dssim: float = 0.2

    # -- per-camera exposure compensation (train/exposure.py) --
    use_exposure: bool = False
    exposure_lr: float = 1e-3

    # -- pool --
    capacity: int = 2 ** 17          # Gaussian slot-pool capacity

    # -- mesh (parallel/mesh.py, parallel/sharded.py) --
    mesh_data: int = 1               # cameras trained side by side
    mesh_tile: int = 1               # image bands of whole tile rows
    ring_exchange: bool = False      # ring exchange of depth-rank-range segments (parallel/ring.py)
