"""Training orchestration (counterpart of mini3dgs_tpu/train/trainer.py).

The single-device step and the density-control steps around it
(`train_step`, `densify_step`, `prune_step`, `reset_opacity_step`), the
pool's capacity changes (`grow_capacity`, `compact_train_state`), and
`GaussianTrainer`, which runs them: dataset -> Gaussians from its point
cloud -> steps with densify / prune / opacity reset / progressive SH /
growth / one compaction after the densify window -> validation ->
checkpoints.

State is functional, as in the JAX package: every step takes a `TrainState`
and returns a new one, leaving its argument untouched.  PyTorch runs
eagerly, so there is nothing to jit and a step is a plain function of
(state, camera).  The JAX trainer's K-step device loop and its stream
sizers work around static shapes and dispatch cost on the TPU and have no
counterpart: the port's stream holds exactly the live instances.  Over a
(data, tile) mesh of ranks (`mesh_data * mesh_tile > 1`) `GaussianTrainer`
drives the steps of parallel/sharded.py, which share `apply_gradients`,
with the state replicated or, with `shard_gauss_state`, split over the
ranks; the density-control steps and the capacity changes then run on the
gathered state, which is split again after them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import TrainingConfig
from ..core.camera import Camera
from ..core.gaussians import (Gaussians, compact, compact_capacity,
                              create_from_pcd, empty_gaussians, reset_opacity,
                              scene_extent_of)
from ..core.loss import gaussian_loss, ssim
from ..core.sh import rgb_to_sh_dc
from ..data.dataset import load_dataset
from ..ops.renderer import RenderSettings, render
from ..utils import profiling
from ..utils.metrics import psnr
from . import density
from .exposure import apply_exposure, init_exposure
from .optimizer import (AdamState, adam_update, init_adam, reset_adam_slots,
                        step_lrs)


@dataclass
class TrainState:
    gaussians: Gaussians
    opt_state: AdamState
    step: int
    # optional per-camera exposure compensation (train/exposure.py)
    exposure: Optional[torch.Tensor] = None       # [n_cams, 3, 4]
    exp_opt_state: Optional[AdamState] = None

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    @property
    def capacity(self) -> int:
        return self.gaussians.capacity


def create_train_state(gaussians: Gaussians, config: TrainingConfig,
                       n_cameras: int = 0) -> TrainState:
    exposure = exp_opt = None
    if config.use_exposure and n_cameras > 0:
        exposure = init_exposure(n_cameras, gaussians.device)
        exp_opt = init_adam({"exposure": exposure})
    return TrainState(gaussians=gaussians,
                      opt_state=init_adam(gaussians.params()), step=0,
                      exposure=exposure, exp_opt_state=exp_opt)


def scale_position_lr(config: TrainingConfig,
                      scene_extent: float) -> TrainingConfig:
    """Canonical 3DGS: the position learning rates times the scene extent.
    Applied once; the returned config has the flag cleared."""
    if not config.scale_position_lr_by_extent:
        return config
    return dataclasses.replace(
        config, position_lr_init=config.position_lr_init * scene_extent,
        position_lr_final=config.position_lr_final * scene_extent,
        scale_position_lr_by_extent=False)


@profiling.step("train_step")
def train_step(state: TrainState, camera: Camera, config: TrainingConfig,
               settings: RenderSettings, cam_idx: int = 0,
               sh_degree: Optional[int] = None
               ) -> Tuple[TrainState, Dict[str, float]]:
    """One step: render with the viewspace probe -> L1 + D-SSIM against
    `camera.image` -> gradients -> masked Adam -> densify statistics.
    `sh_degree` overrides the settings' degree (progressive SH unlock).
    The metrics are tensors on the state's device (and the stream counters
    ints); reading one waits for the device."""
    if sh_degree is not None:
        settings = settings.replace(sh_degree=sh_degree)
    g0 = state.gaussians
    params = {k: v.detach().requires_grad_(True)
              for k, v in g0.params().items()}
    # A zero probe on the projected means: its gradient is the viewspace
    # densification statistic.
    probe = torch.zeros(g0.capacity, 2, dtype=torch.float32,
                        device=g0.device, requires_grad=True)
    exposure = None
    if state.exposure is not None:
        exposure = state.exposure.detach().requires_grad_(True)

    out = render(g0.with_params(params), camera, settings,
                 means2d_probe=probe)
    with profiling.stage("3dgs:loss"):
        image = out["image"]
        if exposure is not None:
            image = apply_exposure(exposure[cam_idx], image)
        total, parts = gaussian_loss(image, camera.image, config.lambda_dssim)
    wrt = list(params.values()) + [probe]
    if exposure is not None:
        wrt.append(exposure)
    with profiling.stage("3dgs:backward"):
        grads_all = torch.autograd.grad(total, wrt, allow_unused=True)
    profiling.count_nonfinite("grad_nonfinite", grads_all[:len(params)])
    new_state = apply_gradients(state, params, probe, exposure, grads_all,
                                config, settings, out["radii"].detach(),
                                out["visibility_filter"])
    metrics = {k: v.detach() for k, v in parts.items()}
    metrics.update(render_drops=out["n_dropped"],
                   render_drops_large=out["n_dropped_large"],
                   render_instances=out["n_live"],
                   render_n_large=out["n_large"],
                   n_visible=out["visibility_filter"].sum())
    return new_state, metrics


def mask_dead_gradients(params: Dict[str, torch.Tensor], grads_all,
                        alive: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-parameter gradients with the dead slots' rows (and a parameter
    the loss does not reach) set to 0."""
    grads = {}
    for (k, p), gr in zip(params.items(), grads_all):
        mask = alive.reshape((-1,) + (1,) * (p.ndim - 1))
        grads[k] = torch.where(mask, torch.zeros_like(p) if gr is None else gr,
                               torch.zeros_like(p))
    return grads


def apply_gradients(state: TrainState, params: Dict[str, torch.Tensor],
                    probe: torch.Tensor, exposure: Optional[torch.Tensor],
                    grads_all, config: TrainingConfig,
                    settings: RenderSettings, radii: torch.Tensor,
                    visible: torch.Tensor) -> TrainState:
    """The second half of a step, shared by the single-device and the
    sharded step: `grads_all` are the gradients of the leaves `params`,
    `probe` and (when not None) `exposure`, in that order -> masked Adam ->
    densify statistics with the forward pass's `radii` and `visible`."""
    g0 = state.gaussians
    zero_if_none = lambda gr, ref: torch.zeros_like(ref) if gr is None else gr
    with profiling.stage("3dgs:adam"):
        # Dead slots must not drift: zero their gradients (their Adam
        # moments are zeroed when the slot dies, so their updates stay
        # exactly 0).
        grads = mask_dead_gradients(params, grads_all, g0.alive)
        vs_grads = zero_if_none(grads_all[len(params)], probe)

        detached = {k: v.detach() for k, v in params.items()}
        new_params, opt_state = adam_update(
            detached, grads, state.opt_state,
            *step_lrs(config, state.opt_state.sched_count))
        new_exposure, exp_opt = state.exposure, state.exp_opt_state
        if exposure is not None:
            upd, exp_opt = adam_update(
                {"exposure": exposure.detach()},
                {"exposure": zero_if_none(grads_all[-1], exposure)}, exp_opt,
                {"exposure": config.exposure_lr})
            new_exposure = upd["exposure"]
    with profiling.stage("3dgs:statistics"):
        stat = density.densify_stat_norm(config, grads["xyz"], vs_grads,
                                         settings.image_height,
                                         settings.image_width)
        g = density.accumulate_grad_stats(
            g0.with_params(new_params), stat, radii, visible)
    return TrainState(gaussians=g, opt_state=opt_state, step=state.step + 1,
                      exposure=new_exposure, exp_opt_state=exp_opt)


def densify_step(state: TrainState, noise: torch.Tensor, scene_extent: float,
                 config: TrainingConfig, size_prune: bool = False
                 ) -> Tuple[TrainState, Dict[str, int]]:
    """Split, clone and prune; the Adam moments of every slot whose identity
    changed are zeroed.  `noise` [C,3] are the clone jitter's N(0,1) draws."""
    result = density.densify_and_prune(state.gaussians, noise, scene_extent,
                                       config, size_prune=size_prune)
    stats = {"n_split": result.n_split, "n_clone": result.n_clone,
             "n_pruned": result.n_pruned, "n_dropped": result.n_dropped,
             "n_alive": result.gaussians.num_alive()}
    return state.replace(
        gaussians=result.gaussians,
        opt_state=reset_adam_slots(state.opt_state,
                                   result.changed_slots)), stats


def prune_step(state: TrainState,
               config: TrainingConfig) -> Tuple[TrainState, int]:
    """Standalone opacity prune; newly dead slots get their Adam moments
    zeroed so that their (masked, zero) gradients give zero updates."""
    g, n_pruned = density.prune_only(state.gaussians, config)
    newly_dead = state.gaussians.alive & ~g.alive
    return state.replace(
        gaussians=g,
        opt_state=reset_adam_slots(state.opt_state, newly_dead)), n_pruned


def reset_opacity_step(state: TrainState) -> TrainState:
    return state.replace(gaussians=reset_opacity(state.gaussians, 0.01))


def grow_capacity(state: TrainState, new_capacity: int) -> TrainState:
    """The pool (and the Adam moments) padded to `new_capacity` slots: the
    new slots are dead, with zero moments."""
    g = state.gaussians
    old = g.capacity
    if new_capacity < old:
        raise ValueError(f"grow_capacity: {new_capacity} < {old} slots")
    pad = empty_gaussians(new_capacity - old, g.device)
    new_g = Gaussians(**{f.name: torch.cat([getattr(g, f.name),
                                            getattr(pad, f.name)])
                         for f in dataclasses.fields(g)})

    def pad_moment(x):
        return torch.cat([x, x.new_zeros((new_capacity - old,) + x.shape[1:])])

    s = state.opt_state
    opt = AdamState(count=s.count, sched_count=s.sched_count,
                    mu={k: pad_moment(v) for k, v in s.mu.items()},
                    nu={k: pad_moment(v) for k, v in s.nu.items()})
    return state.replace(gaussians=new_g, opt_state=opt)


def compact_train_state(state: TrainState,
                        capacity: Optional[int] = None) -> TrainState:
    """Alive Gaussians packed to the front of a smaller pool
    (core.gaussians.compact), their Adam moments gathered along."""
    g = state.gaussians
    idx = torch.nonzero(g.alive)[:, 0]
    new_g = compact(g, capacity)

    def gather(x):
        out = x.new_zeros((new_g.capacity,) + x.shape[1:])
        out[:idx.shape[0]] = x[idx]
        return out

    s = state.opt_state
    opt = AdamState(count=s.count, sched_count=s.sched_count,
                    mu={k: gather(v) for k, v in s.mu.items()},
                    nu={k: gather(v) for k, v in s.nu.items()})
    return state.replace(gaussians=new_g, opt_state=opt)


def resolve_device(name: str) -> torch.device:
    """`config.device` as a torch device: "cpu" is the CPU; "cuda" and the
    JAX package's "tpu" are the card, with its index made explicit (a
    tensor reports "cuda:0", never "cuda").  Raises if the card is asked
    for and there is none."""
    dev = torch.device("cuda" if name in ("tpu", "cuda") else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} asks for the card, but "
                           "torch.cuda.is_available() is False; set device "
                           "to 'cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class GaussianTrainer:
    """setup / train / train_step / validate / save_checkpoint /
    load_checkpoint / get_scene_extent, on `config.device`."""

    def __init__(self, config: TrainingConfig,
                 settings: Optional[RenderSettings] = None):
        self.config = config
        self.settings = settings
        self.device = resolve_device(config.device)
        self.dataset = None
        self.state: Optional[TrainState] = None
        self.iteration = 0
        self.scene_extent = 0.0
        self.train_losses: List[float] = []
        self.val_losses: List[float] = []
        self._state_compacted = False
        self.mesh = None

    # ------------------------------------------------------------------
    def setup(self, dataset=None, gaussians: Optional[Gaussians] = None):
        """Dataset (loaded from the config unless given) -> Gaussians from
        its point cloud (unless given) -> render settings -> scene extent
        -> position-LR scaling -> train state; over a mesh (`mesh_data *
        mesh_tile > 1`) the mesh, the gradient self-check
        (`verify_sharding`) and the split of the state over the ranks
        (`shard_gauss_state`).  The mesh's ranks are on the CPU when the
        config says so, else on the visible cards."""
        cfg = self.config
        if dataset is None and gaussians is None:
            dataset = load_dataset(cfg, self.device)
        self.dataset = dataset
        for cam in list(self.train_cameras()) + list(
                dataset.get_test_cameras() if dataset else []):
            if cam.R.device != self.device:
                raise ValueError(f"camera {cam.uid} is on {cam.R.device}, "
                                 f"the trainer on {self.device}")
        if gaussians is None:
            points, colors = dataset.get_point_cloud()
            if cfg.color_mode == "sh" and colors is not None:
                # SH decode is rgb = C0*dc + 0.5 (core/sh.py); invert the DC
                # term so the initial render reproduces the cloud's colours
                colors = rgb_to_sh_dc(np.asarray(colors, np.float32))
            cap = max(cfg.capacity,
                      1 << int(np.ceil(np.log2(max(len(points), 2)))))
            gaussians = create_from_pcd(points, colors, capacity=cap,
                                        device=self.device)
        gaussians = gaussians.to(self.device)
        if self.settings is None:
            cam0 = self.train_cameras()[0]
            # A dataset whose targets are composited onto a fixed background
            # (BlenderDataset) sets the render background.
            bg = getattr(self.dataset, "bg_color", None)
            if bg is None:
                bg = cfg.background_color
            self.settings = RenderSettings(
                image_height=cam0.height, image_width=cam0.width,
                bg_color=tuple(float(v) for v in bg),
                tile_size=cfg.tile_size, radius_min=cfg.radius_min,
                radius_max=cfg.radius_max, color_mode=cfg.color_mode,
                sh_degree=0 if cfg.color_mode == "dc_sigmoid" else cfg.sh_degree,
                antialias=cfg.antialias,
                raster="tiles" if cfg.use_pallas else "golden",
                ring=cfg.ring_exchange, ring_reshard=cfg.ring_reshard,
                ring_local=cfg.ring_local)
        # Canonical scene extent: 1.1x the camera rig's largest distance
        # from its centre (the unit of the densify thresholds and of the
        # position-LR scaling); without cameras, the cloud's mean range.
        if self.dataset is not None and getattr(self.dataset, "cameras",
                                                None):
            self.scene_extent = 1.1 * float(
                self.dataset.get_scene_info()["radius"])
        else:
            self.scene_extent = float(scene_extent_of(gaussians))
        self.config = scale_position_lr(self.config, self.scene_extent)
        n_cams = len(self.train_cameras()) if self.dataset is not None else 0
        self.state = create_train_state(gaussians, self.config,
                                        n_cameras=n_cams)
        self.mesh = None
        if cfg.mesh_data * cfg.mesh_tile > 1:
            self._setup_mesh()

    def _setup_mesh(self) -> None:
        from ..parallel import sharded
        from ..parallel.mesh import make_mesh
        cfg = self.config
        if self.settings.raster != "tiles":
            raise ValueError("the band-sharded steps run the tile kernels: "
                             "set use_pallas true to train over a mesh")
        self.mesh = make_mesh(
            cfg.mesh_data, cfg.mesh_tile,
            [self.device] if self.device.type == "cpu" else None)
        if cfg.verify_sharding:
            sharded.verify_shard_grad_parity(
                cfg, self.mesh, gauss_sharded=cfg.shard_gauss_state)
        self._set_state(self.state)

    @property
    def _gauss_sharded(self) -> bool:
        """True when the state is split over the mesh's ranks."""
        from ..parallel.sharded import GaussShardedState
        return isinstance(self.state, GaussShardedState)

    def gathered_state(self) -> TrainState:
        """The whole train state on the trainer's device (a gathered copy
        when the state is split over the mesh's ranks)."""
        if not self._gauss_sharded:
            return self.state
        from ..parallel.sharded import gather_train_state
        return gather_train_state(self.state, self.mesh, self.device)

    def _set_state(self, state: TrainState) -> None:
        """Install a whole train state, split over the mesh's ranks when
        the trainer keeps it sharded (`shard_gauss_state`)."""
        if self.mesh is not None and self.config.shard_gauss_state:
            from ..parallel.sharded import shard_train_state
            state = shard_train_state(state, self.mesh)
        self.state = state

    def train_cameras(self) -> Sequence[Camera]:
        return self.dataset.get_train_cameras() if self.dataset else []

    def get_scene_extent(self) -> float:
        return float(scene_extent_of(self.gathered_state().gaussians))

    # ------------------------------------------------------------------
    def active_sh_degree(self) -> int:
        """Progressive SH unlock (canonical 3DGS: one band per interval)."""
        if self.settings.color_mode != "sh" or self.config.sh_increase_interval <= 0:
            return self.settings.sh_degree
        return min(self.iteration // self.config.sh_increase_interval,
                   self.config.sh_degree)

    def train_step(self, camera, cam_idx=0) -> Dict:
        """One step at the active SH degree.  Over a mesh `camera` is one
        Camera per rank of the data axis (with `cam_idx` their indices into
        the exposure table), or one Camera that every data rank trains.  The
        metrics are tensors on the device (the stream counters ints):
        reading one waits for it."""
        deg = self.active_sh_degree()
        if self.mesh is None:
            self.state, metrics = train_step(
                self.state, camera, self.config, self.settings, cam_idx,
                sh_degree=deg)
        else:
            from ..parallel import sharded
            n = self.mesh.data
            batched = isinstance(camera, (list, tuple))
            cams = list(camera) if batched else [camera] * n
            if isinstance(cam_idx, (list, tuple, np.ndarray)):
                idx = [int(i) for i in cam_idx]
            elif self.config.use_exposure and batched and n > 1:
                raise ValueError(
                    f"use_exposure with {n} cameras needs a cam_idx per "
                    f"camera, not the one index {cam_idx}: it would train "
                    "that camera's exposure for every data rank")
            else:
                idx = [int(cam_idx)] * n
            make = (sharded.make_gauss_sharded_train_step
                    if self._gauss_sharded else
                    sharded.make_sharded_train_step)
            self.state, metrics = make(self.config, self.settings,
                                       self.mesh)(self.state, cams, idx,
                                                  sh_degree=deg)
        self.iteration += 1
        return metrics

    def _clone_noise(self, iteration: int, capacity: int) -> torch.Tensor:
        """The clone jitter's N(0,1) draws [capacity, 3] for the densify
        event at `iteration`, from a generator on the device seeded by
        (config.seed, iteration): a resumed run draws what the
        uninterrupted one did."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed * 2 ** 32 + iteration)
        return torch.randn(capacity, 3, generator=gen, device=self.device)

    def _maybe_compact_state(self) -> None:
        """Once the densify window closes the population no longer grows:
        compact the pool once, if that saves at least a quarter of it.
        Over a mesh the new capacity is rounded up to a multiple of the
        ranks."""
        self._state_compacted = True
        state = self.gathered_state()
        cap = state.gaussians.capacity
        n = state.gaussians.num_alive()
        new_cap = compact_capacity(n)
        if self.mesh is not None:
            n_dev = self.mesh.data * self.mesh.tile
            new_cap = -(-new_cap // n_dev) * n_dev
        if new_cap > 0.75 * cap:
            return
        print(f"[compact] densify window closed: pool {cap} -> {new_cap} "
              f"({n} alive)", flush=True)
        self._set_state(compact_train_state(state, new_cap))

    def train(self, iterations: Optional[int] = None,
              log_fn: Optional[Callable] = None) -> Dict:
        """Steps from `self.iteration` on, with the events of each step in
        the JAX trainer's order: densify (or prune), opacity reset,
        compaction, log, validation, checkpoint.  The camera of step i is
        the i-th draw of default_rng(config.seed), as in the JAX trainer
        for a run from step 0 (over a mesh, the cameras of step i are the
        next `mesh_data` draws); a resumed run continues the sequence (the
        JAX trainer restarts it).  On a sharded state densify runs through
        parallel/sharded.make_gauss_sharded_densify_step, and prune,
        growth and opacity reset on the gathered state, split again after
        them.  The host reads the device only at densify, prune,
        compaction, log and validation events."""
        cfg = self.config
        iterations = iterations or cfg.iterations
        cams = list(self.train_cameras())
        n_data = self.mesh.data if self.mesh is not None else 1
        rng = np.random.default_rng(cfg.seed)
        for _ in range(self.iteration * n_data):
            rng.integers(len(cams))
        metrics = {}
        end = self.iteration + iterations
        while self.iteration < end:
            it = self.iteration + 1
            idxs = [int(rng.integers(len(cams))) for _ in range(n_data)]
            if n_data == 1:
                metrics = self.train_step(cams[idxs[0]], idxs[0])
            else:
                metrics = self.train_step([cams[i] for i in idxs], idxs)
            if density.should_densify(it, cfg):
                # the canonical big-point prune starts after the first
                # opacity reset
                size_prune = 0 < cfg.opacity_reset_interval < it
                cap = self.state.capacity
                noise = self._clone_noise(it, cap)
                if self._gauss_sharded:
                    from ..parallel.sharded import \
                        make_gauss_sharded_densify_step
                    self.state, dstats = make_gauss_sharded_densify_step(
                        cfg, self.mesh)(self.state, noise, self.scene_extent,
                                        size_prune)
                else:
                    self.state, dstats = densify_step(
                        self.state, noise, self.scene_extent, cfg,
                        size_prune)
                metrics.update(dstats)
                if dstats["n_alive"] > 0.85 * cap:
                    self._set_state(grow_capacity(self.gathered_state(),
                                                  2 * cap))
            elif density.should_prune(it, cfg):
                state, metrics["n_pruned"] = prune_step(self.gathered_state(),
                                                        cfg)
                self._set_state(state)
            if (cfg.opacity_reset_interval > 0
                    and it % cfg.opacity_reset_interval == 0
                    and it <= cfg.densify_until_iter):
                self._set_state(reset_opacity_step(self.gathered_state()))
            if (cfg.compact_after_densify and not self._state_compacted
                    and 0 < cfg.densify_until_iter <= it):
                self._maybe_compact_state()
            if it % cfg.log_interval == 0:
                self.train_losses.append(float(metrics["total_loss"]))
                if log_fn:
                    log_fn(it, {k: float(v) for k, v in metrics.items()})
            if it % cfg.eval_interval == 0 and self.dataset is not None:
                self.val_losses.append(self.validate().get("psnr", 0.0))
            if it % cfg.save_interval == 0:
                self.save_checkpoint(it)
        return metrics

    # ------------------------------------------------------------------
    def _mesh_render_fn(self, st: RenderSettings) -> Optional[Callable]:
        """The band-sharded renderer of the mesh for settings `st` (over
        the split pool when the state is sharded), or None without a mesh
        or when `st`'s height does not split into the bands."""
        if self.mesh is None or \
                st.image_height % (self.mesh.tile * st.tile_size):
            return None
        from ..parallel import sharded
        if self._gauss_sharded:
            fn = sharded.make_gauss_sharded_render(st, self.mesh)
            return lambda cam: fn([s.gaussians for s in self.state.shards],
                                  cam)
        fn = sharded.make_sharded_render(st, self.mesh)
        return lambda cam: fn(self.state.gaussians, cam)

    @torch.no_grad()
    def validate(self) -> Dict[str, float]:
        """Mean PSNR and SSIM over the test split (each view rendered at
        its own size), read back once for all views.  Over a mesh a view
        renders band-sharded, or, when its height does not split into the
        bands, on one device."""
        cams = self.dataset.get_test_cameras() if self.dataset else []
        if not cams:
            return {}
        psnrs, ssims = [], []
        whole = None
        for cam in cams:
            st = self.settings
            if (cam.height != st.image_height or cam.width != st.image_width):
                st = st.replace(image_height=cam.height, image_width=cam.width)
            mesh_render = self._mesh_render_fn(st)
            if mesh_render is not None:
                image = mesh_render(cam)["image"]
            else:
                if whole is None:
                    whole = self._gathered_gaussians()
                image = render(whole, cam, st)["image"]
            psnrs.append(psnr(image, cam.image))
            ssims.append(ssim(image, cam.image))
        return {"psnr": float(np.mean(torch.stack(psnrs).tolist())),
                "ssim": float(np.mean(torch.stack(ssims).tolist()))}

    def _gathered_gaussians(self) -> Gaussians:
        if not self._gauss_sharded:
            return self.state.gaussians
        from ..parallel.sharded import gather_gaussians
        return gather_gaussians([s.gaussians for s in self.state.shards],
                                self.mesh, self.device)

    def save_checkpoint(self, iteration: int) -> None:
        """A sharded state is written gathered, in the layout of a
        single-device checkpoint: either kind of run loads the other's."""
        from .checkpoint import save_checkpoint
        save_checkpoint(self.config.output_path, iteration,
                        self.gathered_state(),
                        extra={"compacted": int(self._state_compacted)})

    def load_checkpoint(self, iteration: int) -> None:
        """Resume from the checkpoint of `iteration`, whatever its pool's
        capacity: a pool smaller than this trainer's (compacted) or a run
        that had already passed its compaction check is not compacted
        again.  A trainer over a mesh with `shard_gauss_state` splits the
        loaded state over its ranks."""
        from .checkpoint import load_checkpoint
        state, extra = load_checkpoint(self.config.output_path, iteration,
                                       self.device)
        cap = self.state.capacity if self.state is not None else None
        if cap is not None and state.gaussians.capacity < cap:
            print(f"[load_checkpoint] compacted checkpoint: {cap} -> "
                  f"{state.gaussians.capacity} slots", flush=True)
            self._state_compacted = True
        self._state_compacted |= bool(extra.get("compacted", 0))
        self._set_state(state)
        self.iteration = state.step
