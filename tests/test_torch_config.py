"""The port's configuration against the JAX package's: its YAML subset
parser against PyYAML on every file in configs/, `ConfigManager` against
the JAX `ConfigManager` field by field, the writer's round trip, and the
keys the port refuses or reports.  Every comparison is exact."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch
import yaml

from mini3dgs_tpu import config as jconfig
from mini3dgs_tpu_torch import config as tconfig
from mini3dgs_tpu_torch.utils import yaml_subset

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


def _shared_fields(cfg):
    """The port's fields that the JAX package has too (each of the others,
    `PORT_ONLY_KEYS`, keeps the JAX package's behaviour at its default)."""
    assert not set(tconfig.PORT_ONLY_KEYS) & {
        f.name for f in dataclasses.fields(jconfig.TrainingConfig)}
    return [f for f in dataclasses.fields(cfg)
            if f.name not in tconfig.PORT_ONLY_KEYS]


def test_there_are_configs():
    assert len(CONFIGS) >= 5


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_parser_equals_pyyaml_on_every_config(path):
    text = path.read_text()
    want = yaml.safe_load(text)
    got = yaml_subset.loads(text)
    assert got == want
    # the same types too (1 == 1.0 == True would hide a wrong resolution)
    flat = lambda d: [(k, type(v)) for k, v in d.items()] if isinstance(
        d, dict) else [type(d)]
    for k in want:
        assert flat(got[k]) == flat(want[k]), k


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_manager_matches_jax_on_every_config(path, capsys):
    want = jconfig.ConfigManager.load_from_yaml(str(path))
    got = tconfig.ConfigManager.load_from_yaml(str(path))
    for f in _shared_fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert type(getattr(got, f.name)) is type(getattr(want, f.name)), \
            f.name


SCALARS = """\
a: 1e-5
b: 1.0e5
c: 1.0e-5
d: yes
e: 1_000
f: .5
g: 5.
h: -0
i: +3
j: 'x''y'
k: [1, 'a', b, 2.0, -.inf]
l:
m: ~
n: -1.5e+3
o: "a\\"b"  # a comment
p: a#b
q: []
r: Off
s:
  t:
    u: NULL
  v: 2
w: 3
"""


def test_parser_resolves_scalars_as_pyyaml():
    """YAML 1.1 resolution: `1e-5` and `1.0e5` stay strings, yes / Off are
    bools, `.5` and `5.` floats, underscores dropped, comments stripped
    outside quotes."""
    assert yaml_subset.loads(SCALARS) == yaml.safe_load(SCALARS)
    assert yaml_subset.loads("") is None
    assert yaml_subset.loads("# only a comment\n") is None


@pytest.mark.parametrize("text", [
    "a: 010", "a: 0x1f", "a: 1:30", "- a", "a:\n  - 1", "a: &x 1",
    "a: *x", "a: !!str 1", "a: [1, [2]]", "a: {b: 1}", "a: b: c",
    "a: |\n  x", "a: 1\n a2: 2", "a: 1\na: 2", "---\na: 1", "a: [1, 2",
    "a: 'x", "\ta: 1", "'a': 1"])
def test_parser_raises_outside_the_subset(text):
    with pytest.raises(ValueError, match="subset"):
        yaml_subset.loads(text)


def test_save_to_yaml_round_trips(tmp_path):
    """Non-default values of every type (a float PyYAML would misread
    without a dot, a list, a path with a space) come back equal, through
    the port's parser and through PyYAML."""
    cfg = dataclasses.replace(
        tconfig.TrainingConfig(), position_lr_final=1e-7,
        background_color=[1.0, 0.5, 0.25], data_path="a b/c", seed=7,
        use_pallas=False, densify_grad_threshold=2e-4, device="cpu")
    path = tmp_path / "sub" / "cfg.yaml"
    tconfig.ConfigManager.save_to_yaml(cfg, str(path))
    assert tconfig.ConfigManager.load_from_yaml(str(path)) == cfg
    assert yaml.safe_load(path.read_text()) == dataclasses.asdict(cfg)
    # the JAX package reads the port's file to the same fields
    j = jconfig.ConfigManager.load_from_yaml(str(path))
    for f in _shared_fields(cfg):
        assert getattr(j, f.name) == getattr(cfg, f.name), f.name


def test_json_config_is_accepted(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"training": {"iterations": 12},
                                "rendering": {"tile_size": 32},
                                "learning_rates": {"position": {"init": 1e-3}}}))
    cfg = tconfig.ConfigManager.load_from_yaml(str(path))
    assert (cfg.iterations, cfg.tile_size, cfg.position_lr_init) == \
        (12, 32, 1e-3)
    assert tconfig.ConfigManager.get_default_config() == \
        tconfig.TrainingConfig()


@pytest.mark.parametrize("key,value", [
    ("ring_reshard", True), ("ring_local", True),
    ("ring_reshard_capacity", 64)])
def test_route_keys_not_ported_raise(tmp_path, key, value, capsys):
    """The keys of ring v2 / v3, which raised until the port had them, now
    load: `ring_reshard` and `ring_local` into TrainingConfig as the JAX
    package reads them, `ring_reshard_capacity` (the TPU's reshard bucket)
    reported as shape-only and unused."""
    path = tmp_path / "cfg.yaml"
    path.write_text(f"tpu:\n  {key}: {json.dumps(value)}\n")
    cfg = tconfig.ConfigManager.load_from_yaml(str(path))
    want = jconfig.ConfigManager.load_from_yaml(str(path))
    err = capsys.readouterr().err
    if key in tconfig.SHAPE_ONLY_KEYS:
        assert f"{key}={value!r}" in err
        assert cfg == tconfig.TrainingConfig()
    else:
        assert getattr(cfg, key) == getattr(want, key) == value
        assert cfg == dataclasses.replace(tconfig.TrainingConfig(),
                                          **{key: value})
        assert "[config]" not in err


@pytest.mark.parametrize("key,value", [("shard_gauss_state", True),
                                       ("verify_sharding", False)])
def test_mesh_keys_load_and_reach_the_trainer(tmp_path, key, value,
                                              monkeypatch):
    """`shard_gauss_state` and `verify_sharding` read from YAML as the JAX
    package reads them, and a trainer over a (1, 2) mesh acts on them: the
    state is split over the ranks, the setup's gradient self-check runs or
    not."""
    from mini3dgs_tpu_torch.data.dataset import RandomDataset
    from mini3dgs_tpu_torch.parallel import sharded
    from mini3dgs_tpu_torch.train.trainer import GaussianTrainer
    path = tmp_path / "cfg.yaml"
    path.write_text(f"tpu:\n  {key}: {json.dumps(value)}\n  mesh_tile: 2\n"
                    "  capacity: 256\nsystem:\n  device: cpu\n")
    cfg = tconfig.ConfigManager.load_from_yaml(str(path))
    want = jconfig.ConfigManager.load_from_yaml(str(path))
    assert getattr(cfg, key) == getattr(want, key) == value
    checks = []
    verify = sharded.verify_shard_grad_parity
    monkeypatch.setattr(sharded, "verify_shard_grad_parity",
                        lambda *a, **kw: checks.append(kw) or verify(*a, **kw))
    ds = RandomDataset(n_cameras=2, width=32, height=32)
    ds.load_cameras()
    t = GaussianTrainer(cfg)
    t.setup(dataset=ds)
    assert (t.mesh.data, t.mesh.tile) == (1, 2)
    assert isinstance(t.state, sharded.GaussShardedState) == \
        cfg.shard_gauss_state
    assert checks == ([{"gauss_sharded": cfg.shard_gauss_state}]
                      if cfg.verify_sharding else [])


def test_shape_only_keys_are_reported(tmp_path, capsys):
    """Keys that size the TPU's shapes are named on stderr, once, with
    their values, and change nothing of the port's config."""
    path = tmp_path / "cfg.yaml"
    path.write_text("tpu:\n  max_instances: 4096\n  gaussian_chunk: 32\n"
                    "  steps_per_call: 0\n  capacity: 512\n"
                    "training:\n  steps_per_call: 4\n")
    cfg = tconfig.ConfigManager.load_from_yaml(str(path))
    err = capsys.readouterr().err
    assert err.count("[config]") == 1
    for k in ("max_instances=4096", "gaussian_chunk=32", "steps_per_call="):
        assert k in err
    assert cfg == dataclasses.replace(tconfig.TrainingConfig(), capacity=512)
    assert set(tconfig.SHAPE_ONLY_KEYS) <= {
        f.name for f in dataclasses.fields(jconfig.TrainingConfig)}
    tconfig.ConfigManager.load_from_yaml(str(CONFIGS[0]))
    assert "[config]" in capsys.readouterr().err


def test_trainer_refuses_a_mesh():
    """A mesh is set up now (over CPU ranks when the config says cpu), but
    the trainer refuses one that the gauss-sharded pool cannot split over
    (a capacity that is no multiple of the ranks, with the numbers) and one
    whose band render would need the golden raster."""
    from mini3dgs_tpu_torch.data.dataset import RandomDataset
    from mini3dgs_tpu_torch.train.trainer import GaussianTrainer
    ds = RandomDataset(n_cameras=2, width=32, height=32)
    ds.load_cameras()
    kw = dict(device="cpu", mesh_data=2, mesh_tile=2, verify_sharding=False)
    t = GaussianTrainer(tconfig.TrainingConfig(capacity=256, **kw))
    t.setup(dataset=ds)
    assert t.mesh.devices == (torch.device("cpu"),) * 4
    t = GaussianTrainer(tconfig.TrainingConfig(capacity=256, **kw,
                                               shard_gauss_state=True))
    t.setup(dataset=ds)
    # the random cloud's 2,000 points take a pool of 2048 slots
    assert [s.gaussians.capacity for s in t.state.shards] == [512] * 4
    t = GaussianTrainer(tconfig.TrainingConfig(capacity=254, **kw,
                                               shard_gauss_state=True))
    with pytest.raises(ValueError, match="254 does not divide over the 4"):
        t.setup(dataset=ds, gaussians=t_pool(254))
    t = GaussianTrainer(tconfig.TrainingConfig(use_pallas=False, **kw))
    with pytest.raises(ValueError, match="use_pallas"):
        t.setup(dataset=ds)


def t_pool(capacity):
    from mini3dgs_tpu_torch import convert
    p, a, _ = convert.flagship_scene_numpy(capacity, 100, seed=0)
    return convert.gaussians_from_numpy(p, a)
