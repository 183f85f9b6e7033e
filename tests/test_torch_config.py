"""The port's configuration against the JAX package's: its YAML subset
parser against PyYAML on every file in configs/, `ConfigManager` against
the JAX `ConfigManager` field by field, the writer's round trip, and the
keys the port refuses or reports.  Every comparison is exact."""

import dataclasses
import json
from pathlib import Path

import pytest
import yaml

from mini3dgs_tpu import config as jconfig
from mini3dgs_tpu_torch import config as tconfig
from mini3dgs_tpu_torch.utils import yaml_subset

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


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
    for f in dataclasses.fields(got):
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
    for f in dataclasses.fields(cfg):
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
    ("shard_gauss_state", True), ("ring_reshard", True), ("ring_local", True),
    ("ring_reshard_capacity", 64), ("verify_sharding", False)])
def test_route_keys_not_ported_raise(tmp_path, key, value):
    path = tmp_path / "cfg.yaml"
    path.write_text(f"tpu:\n  {key}: {json.dumps(value)}\n")
    with pytest.raises(ValueError, match="item 4"):
        tconfig.ConfigManager.load_from_yaml(str(path))
    # at its JAX default the key is accepted
    path.write_text(f"tpu:\n  {key}: "
                    f"{json.dumps(tconfig.ROUTE_KEYS[key])}\n")
    assert tconfig.ConfigManager.load_from_yaml(str(path)) == \
        tconfig.TrainingConfig()


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
    assert set(tconfig.SHAPE_ONLY_KEYS) | set(tconfig.ROUTE_KEYS) <= {
        f.name for f in dataclasses.fields(jconfig.TrainingConfig)}
    tconfig.ConfigManager.load_from_yaml(str(CONFIGS[0]))
    assert "[config]" in capsys.readouterr().err


def test_trainer_refuses_a_mesh():
    from mini3dgs_tpu_torch.train.trainer import GaussianTrainer
    t = GaussianTrainer(tconfig.TrainingConfig(device="cpu", mesh_tile=2))
    with pytest.raises(ValueError, match="item 4"):
        t.setup()
