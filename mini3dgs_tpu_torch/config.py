"""Training configuration (counterpart of mini3dgs_tpu/config.py).

The flat `TrainingConfig` dataclass with the JAX package's field names and
defaults, so a configuration reads the same in both packages, and
`ConfigManager`, which reads the JAX package's YAML files (nested, as in
`configs/`, or flat) without PyYAML (`utils/yaml_subset.py`) and also
accepts JSON.

The JAX package's keys in `SHAPE_ONLY_KEYS` have no field here: they
size the TPU's static shapes or pick its dispatch.  The port's instance
stream holds exactly the live instances, its collectives move
variable-length slices (so the ring v3 reshard needs no bucket capacity)
and it takes one step per call, so they mean nothing here: a file that
sets them is read, and the keys are reported once on stderr.  The other
way round, `PORT_ONLY_KEYS` are the port's fields that the JAX package
lacks; their defaults keep the JAX package's behaviour.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

from .utils import yaml_subset


@dataclass
class TrainingConfig:
    # -- data paths --
    data_path: str = "data/scene"
    images_path: str = "images"
    sparse_path: str = "sparse/0"
    output_path: str = "output"

    # -- training --
    iterations: int = 30000
    batch_size: int = 1
    eval_interval: int = 1000
    save_interval: int = 5000
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
    # "cosine": every group's rate times one cosine factor of the position
    # schedule, as the JAX package has it; "3dgs": the 3DGS paper's code,
    # only the position rate decayed (exponentially), every other group at
    # its constant rate, the SH rest terms at feature_lr / 20
    # (train/optimizer.step_lrs).
    lr_schedule: str = "cosine"

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
    radius_min: float = 0.01
    radius_max: float = 50.0
    sh_degree: int = 3
    color_mode: str = "dc_sigmoid"
    sh_increase_interval: int = 1000  # progressive SH degree unlock
    antialias: bool = False          # mip-splatting 2D dilation

    # -- loss --
    lambda_dssim: float = 0.2

    # -- per-camera exposure compensation (train/exposure.py) --
    use_exposure: bool = False
    exposure_lr: float = 1e-3

    # -- pool --
    capacity: int = 2 ** 17          # Gaussian slot-pool capacity
    # Slot-compact the pool (and Adam moments) once the densify window
    # closes, if that saves at least a quarter of it.
    compact_after_densify: bool = True
    # The raster path: the hand-written tile kernels (RenderSettings.raster
    # "tiles") or the golden compositor ("golden").
    use_pallas: bool = True

    # -- mesh (parallel/mesh.py, parallel/sharded.py) --
    mesh_data: int = 1               # cameras trained side by side
    mesh_tile: int = 1               # image bands of whole tile rows
    ring_exchange: bool = False      # ring exchange of depth-rank-range segments (parallel/ring.py)
    ring_reshard: bool = False       # ring v2: reshard the projected rows by depth range first
    ring_local: bool = False         # ring v3 (gauss-sharded step): the ring takes each rank's block
    # Split the pool and its Adam state over the mesh's ranks (per-rank
    # state memory ~C/n; parallel/sharded.shard_train_state).
    shard_gauss_state: bool = False
    # At setup under a mesh, hold one tiny sharded step's gradients against
    # single-device autograd (parallel/sharded.verify_shard_grad_parity).
    verify_sharding: bool = True

    # -- system --
    device: str = "tpu"              # "cpu", or the card ("cuda"; "tpu" too)
    seed: int = 0


# The JAX package's keys that size the TPU's static shapes or pick its
# dispatch (stream, large-pool, ring-segment and reshard-bucket capacities,
# Pallas chunking, the K-step loop, the dtype knob).  Reported when a file
# sets them, then unused.
SHAPE_ONLY_KEYS = ("max_instances", "gaussian_chunk", "max_dup_per_axis",
                   "large_capacity", "ring_capacity", "ring_reshard_capacity",
                   "steps_per_call", "loop_stage_budget_mb",
                   "auto_max_instances", "dtype")

# The port's fields that the JAX package's TrainingConfig does not have.
PORT_ONLY_KEYS = ("lr_schedule",)

# Mapping from nested YAML groups to flat field names (the JAX package's).
_NESTED_MAP = {
    ("data", "path"): "data_path",
    ("data", "images_path"): "images_path",
    ("data", "sparse_path"): "sparse_path",
    ("data", "output_path"): "output_path",
    ("training", "iterations"): "iterations",
    ("training", "batch_size"): "batch_size",
    ("training", "eval_interval"): "eval_interval",
    ("training", "save_interval"): "save_interval",
    ("training", "log_interval"): "log_interval",
    ("learning_rates", "feature"): "feature_lr",
    ("learning_rates", "opacity"): "opacity_lr",
    ("learning_rates", "scaling"): "scaling_lr",
    ("learning_rates", "rotation"): "rotation_lr",
    ("learning_rates", "schedule"): "lr_schedule",
    ("density_control", "densify_from_iter"): "densify_from_iter",
    ("density_control", "densify_until_iter"): "densify_until_iter",
    ("density_control", "densify_grad_threshold"): "densify_grad_threshold",
    ("density_control", "densify_interval"): "densify_interval",
    ("density_control", "prune_opacity_threshold"): "prune_opacity_threshold",
    ("density_control", "prune_interval"): "prune_interval",
    ("density_control", "opacity_reset_interval"): "opacity_reset_interval",
    ("density_control", "densify_grad_space"): "densify_grad_space",
    ("density_control", "prune_max_screen_size"): "prune_max_screen_size",
    ("density_control", "prune_max_world_size"): "prune_max_world_size",
    ("rendering", "image_height"): "image_height",
    ("rendering", "image_width"): "image_width",
    ("rendering", "background_color"): "background_color",
    ("rendering", "tile_size"): "tile_size",
    ("rendering", "sh_degree"): "sh_degree",
    ("rendering", "color_mode"): "color_mode",
    ("rendering", "antialias"): "antialias",
    ("loss", "lambda_dssim"): "lambda_dssim",
    ("training", "use_exposure"): "use_exposure",
    ("learning_rates", "exposure"): "exposure_lr",
    ("learning_rates", "scale_position_by_extent"): "scale_position_lr_by_extent",
    ("system", "device"): "device",
    ("system", "seed"): "seed",
    ("tpu", "capacity"): "capacity",
    ("tpu", "max_instances"): "max_instances",
    ("tpu", "gaussian_chunk"): "gaussian_chunk",
    ("tpu", "large_capacity"): "large_capacity",
    ("tpu", "max_dup_per_axis"): "max_dup_per_axis",
    ("tpu", "mesh_data"): "mesh_data",
    ("tpu", "mesh_tile"): "mesh_tile",
    ("tpu", "shard_gauss_state"): "shard_gauss_state",
    ("tpu", "ring_exchange"): "ring_exchange",
    ("tpu", "ring_reshard"): "ring_reshard",
    ("tpu", "ring_local"): "ring_local",
    ("tpu", "ring_reshard_capacity"): "ring_reshard_capacity",
    ("tpu", "ring_capacity"): "ring_capacity",
    ("tpu", "verify_sharding"): "verify_sharding",
    ("tpu", "steps_per_call"): "steps_per_call",
    ("tpu", "loop_stage_budget_mb"): "loop_stage_budget_mb",
    ("tpu", "compact_after_densify"): "compact_after_densify",
    ("tpu", "auto_max_instances"): "auto_max_instances",
    ("training", "steps_per_call"): "steps_per_call",
    ("tpu", "use_pallas"): "use_pallas",
}

# learning_rates.position is itself nested one more level.
_POSITION_LR_MAP = {
    "init": "position_lr_init",
    "final": "position_lr_final",
    "delay_mult": "position_lr_delay_mult",
    "delay_steps": "position_lr_delay_steps",
    "max_steps": "position_lr_max_steps",
}


def _flatten_yaml(data: dict) -> dict:
    """Accept either a flat dict of field names or the nested layout.
    Keys of the JAX package's fields that the port does not carry
    (SHAPE_ONLY_KEYS) are kept; unknown keys are dropped."""
    names = ({f.name for f in dataclasses.fields(TrainingConfig)}
             | set(SHAPE_ONLY_KEYS))
    flat: dict = {}
    for key, value in data.items():
        if key in names and not isinstance(value, dict):
            flat[key] = value
        elif isinstance(value, dict):
            for sub, subval in value.items():
                if key == "learning_rates" and sub == "position" and isinstance(subval, dict):
                    for k2, v2 in subval.items():
                        if k2 in _POSITION_LR_MAP:
                            flat[_POSITION_LR_MAP[k2]] = v2
                elif (key, sub) in _NESTED_MAP:
                    flat[_NESTED_MAP[(key, sub)]] = subval
                elif sub in names:
                    flat[sub] = subval
    return flat


def config_from_dict(data: dict, source: str = "config") -> TrainingConfig:
    """TrainingConfig from a nested or flat dict: reports the shape-only
    keys it sets (once, on stderr)."""
    flat = _flatten_yaml(data)
    shape_only = {k: flat.pop(k) for k in list(flat) if k in SHAPE_ONLY_KEYS}
    if shape_only:
        print(f"[config] {source}: not used by the PyTorch port (they size "
              "the TPU's static shapes or pick its dispatch): "
              + ", ".join(f"{k}={v!r}" for k, v in shape_only.items()),
              file=sys.stderr, flush=True)
    return TrainingConfig(**flat)


class ConfigManager:
    """YAML (or JSON) <-> TrainingConfig."""

    @staticmethod
    def load_from_yaml(config_path: str) -> TrainingConfig:
        text = Path(config_path).read_text(encoding="utf-8")
        if Path(config_path).suffix == ".json":
            data = json.loads(text)
        else:
            data = yaml_subset.loads(text)
        return config_from_dict(data or {}, source=str(config_path))

    @staticmethod
    def save_to_yaml(config: TrainingConfig, config_path: str) -> None:
        Path(config_path).parent.mkdir(parents=True, exist_ok=True)
        Path(config_path).write_text(
            yaml_subset.dumps(dataclasses.asdict(config)), encoding="utf-8")

    @staticmethod
    def get_default_config() -> TrainingConfig:
        return TrainingConfig()
