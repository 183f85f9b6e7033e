"""The port's mesh over several OS processes (parallel/distributed.py and the
cross-process paths of parallel/mesh.py, sharded.py, ring.py, core/loss.py
and train/checkpoint.py), on the CPU.

Two processes of scripts/distributed_step_torch.py form one gloo group with
4 CPU ranks each and run the programs of tests/test_multiprocess.py: the
replicated step over `make_global_mesh()` = (2, 4), the gauss-sharded
state's checkpoint over that mesh, ring v1 against the band route and ring
v3 over (1, 8), whose ring hops all cross the processes.  Each process's
results are held against the other's, against the port's single-process
steps on the same numpy inputs, and program 1 against the JAX package's
`make_sharded_train_step` on the virtual CPU devices of tests/conftest.py
(Pallas in interpret mode, tile 16).  Four processes of 2 ranks each run
the collectives and programs 3 and 4 over (1, 8) as well, so that each
process exchanges with several others from several ranks.  Four processes
of one rank each run both steps, both renderers and the gradient check
over (2, 2), whose rows and columns each cross two of the four processes
(one group of processes an axis), and a (1, 2) step that leaves two of
them without a rank.  A worker that fails, or runs out of its time, fails
the tests.
"""

import importlib.util
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mini3dgs_tpu.config import TrainingConfig as JConfig
from mini3dgs_tpu.core.camera import Camera as JCamera
from mini3dgs_tpu.ops import renderer as jren
from mini3dgs_tpu.parallel import mesh as jmesh
from mini3dgs_tpu.parallel import sharded as jsharded
from mini3dgs_tpu.train import trainer as jtrainer
from mini3dgs_tpu_torch.parallel import distributed as D
from mini3dgs_tpu_torch.parallel import mesh as tmesh
from mini3dgs_tpu_torch.parallel import sharded as tsharded
from mini3dgs_tpu_torch.train import checkpoint as tckpt
from tests.test_torch_core import jax_gaussians

REPO = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT = 120  # seconds a worker may take
TOPOLOGY = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DS = load_script("distributed_step_torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread while this module runs: its tensors are small,
    and the test run's other workers need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(out: Path, n_procs: int, ranks: int, *extra) -> tuple:
    """Run `n_procs` processes of the worker with `ranks` CPU ranks each in
    one gloo group: (JSON reports by process, result files by process).
    A worker that fails or runs past WORKER_TIMEOUT fails the caller."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k not in TOPOLOGY}
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "scripts" / "distributed_step_torch.py"),
         "--device", "cpu", "--ranks", str(ranks), "--out", str(out),
         "--coordinator", f"127.0.0.1:{port}", "--num-processes",
         str(n_procs), "--process-id", str(k), "--timeout", "60", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(REPO), env=env) for k in range(n_procs)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                texts = [q.communicate()[0] for q in procs]
                raise AssertionError(
                    f"a worker ran past {WORKER_TIMEOUT} s:\n"
                    + "\n----\n".join(texts))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    reports = {}
    for p, text in zip(procs, outs):
        assert p.returncode == 0, f"worker failed rc={p.returncode}:\n{text}"
        report = json.loads(text.strip().splitlines()[-1])
        reports[report["process"]] = report
    assert sorted(reports) == list(range(n_procs))
    results = {k: torch.load(out / f"result.p{k}.pt", weights_only=True)
               for k in range(n_procs)}
    return reports, results


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Two processes with 4 ranks each, programs 1-4."""
    return run_group(tmp_path_factory.mktemp("distributed"), 2, 4)


@pytest.fixture(scope="module")
def workers_4x2(tmp_path_factory):
    """Four processes with 2 ranks each, the collectives and programs 3
    and 4 over (1, 8): every process exchanges with three others and holds
    two ranks, so a process's messages to several processes interleave."""
    return run_group(tmp_path_factory.mktemp("distributed_4x2"), 4, 2,
                     "--ring-only")


@pytest.fixture(scope="module")
def workers_1x4(tmp_path_factory):
    """Four processes with one rank each: programs 1, 2, 5 and 6 over
    (2, 2), the collectives over each one's row, and program 7 over (1, 2),
    which leaves processes 2 and 3 without a rank."""
    return run_group(tmp_path_factory.mktemp("distributed_1x4"), 4, 1,
                     "--mesh", "2", "2", "--no-ring", "--partial", "1", "2")


@pytest.fixture(scope="module")
def single():
    """The port's single-process steps on the same setup: program 1 and
    2's over a (2, 4) mesh of CPU ranks, 3 and 4's over (1, 8); program 5's
    renders over both."""
    setup = DS.small_setup()
    m24 = tmesh.make_mesh(2, 4, devices=["cpu"])
    m18 = tmesh.make_mesh(1, 8, devices=["cpu"])
    return {"p1": DS.replicated_step(setup["mesh"], m24),
            "p2": DS.gauss_sharded_step(setup["mesh"], m24),
            "p3_band": DS.replicated_step(setup["ring"], m18),
            "p3_ring": DS.replicated_step(setup["ring"], m18, ring=True),
            "p4": DS.gauss_sharded_step(setup["ring"], m18, ring_local=True),
            "p5_mesh": DS.renders(setup["mesh"], m24),
            "p5_ring_mesh_band": DS.renders(setup["ring"], m18),
            "p5_ring_mesh_ring": DS.renders(setup["ring"], m18, ring=True)}


@pytest.fixture(scope="module")
def single_2x2():
    """Programs 1, 2, 5 and 6 over a (2, 2) mesh of CPU ranks in this
    process, and program 7's step over (1, 2)."""
    setup = DS.small_setup()
    m22 = tmesh.make_mesh(2, 2, devices=["cpu"])
    return {"p1": DS.replicated_step(setup["mesh"], m22),
            "p2": DS.gauss_sharded_step(setup["mesh"], m22),
            "p5_mesh": DS.renders(setup["mesh"], m22),
            "p6": DS.grad_parity(setup["mesh"], m22),
            "p7": DS.replicated_step(setup["mesh"],
                                     tmesh.make_mesh(1, 2, devices=["cpu"]))}


def rel(a: float, b: float) -> float:
    return abs(a / b - 1.0)


def test_collectives_cross_the_processes(workers):
    """all_to_all of unequal slices, a partial ppermute, all_gather and
    psum across the boundary, in both processes: forward bitwise the
    single-process list versions, gradients within 1e-6 relative (the
    worker raises otherwise; here the report is read)."""
    reports, _ = workers
    for r in reports.values():
        assert r["mesh"] == [2, 4] and r["ring_mesh"] == [1, 8]
        assert r["groups"] == []  # every axis in one process or in both
        assert r["collectives"]["forward_bitwise"] is True
        assert r["collectives"]["grad_rel_max"] <= 1e-6


def test_replicated_step_over_processes(workers, single):
    """Program 1 over make_global_mesh() = (2, 4), band route: the two
    processes' loss and xyz bitwise equal (one gradient all_reduce, one
    Adam step on the same bits); against the single-process (2, 4) step
    loss rel <= 1e-6, xyz max abs <= 1e-6.  The step puts the loss mean
    and the gradient sum through torch.distributed, nothing else."""
    reports, results = workers
    a, b = results[0], results[1]
    assert a["losses"]["p1"] == b["losses"]["p1"]
    assert torch.equal(a["p1_xyz"], b["p1_xyz"])
    ref = single["p1"]
    assert rel(a["losses"]["p1"], ref["loss"]) <= 1e-6
    assert float((a["p1_xyz"] - ref["xyz"]).abs().max()) <= 1e-6
    assert float((a["p1_xyz"] - DS.small_setup()["mesh"]["state"]
                  .gaussians.xyz).abs().max()) > 0
    assert all(r["p1"]["calls"] == 4 for r in reports.values())


def test_replicated_step_matches_jax(workers):
    """Program 1 against the JAX package's `make_sharded_train_step` on a
    (2, 4) mesh of virtual CPU devices with the Pallas kernels in interpret
    mode at tile 16: loss rtol 1e-5, the xyz abs-sum rtol 1e-4 (the
    tolerances of tests/test_multiprocess.py)."""
    _, results = workers
    params, alive = DS.random_scene(40, seed=2, spread=0.35, capacity=64)
    target = np.random.default_rng(7).uniform(0, 1, (3, 64, 64)) \
        .astype(np.float32)
    jc = JConfig(capacity=64, image_height=64, image_width=64, tile_size=16,
                 use_pallas=True, max_instances=2048, gaussian_chunk=32)
    jset = jren.RenderSettings(image_height=64, image_width=64,
                               tile_size=16, use_pallas=True,
                               max_instances=2048, gaussian_chunk=32)
    fov = math.radians(70.0)
    jcam = JCamera.create(0, np.eye(3), np.zeros(3), fov, fov, width=64,
                          height=64).replace(image=jnp.asarray(target))
    jcams = jax.tree.map(lambda x: jnp.stack([x, x]), jcam)
    jstate = jtrainer.create_train_state(jax_gaussians(params, alive), jc)
    new, m = jsharded.make_sharded_train_step(
        jc, jset, jmesh.make_mesh(data=2, tile=4))(jstate, jcams)
    np.testing.assert_allclose(results[0]["losses"]["p1"],
                               float(m["total_loss"]), rtol=1e-5)
    np.testing.assert_allclose(
        float(results[0]["p1_xyz"].abs().sum()),
        float(np.abs(np.asarray(new.gaussians.xyz)).sum()), rtol=1e-4)


def test_sharded_checkpoint_and_gauss_sharded_step(workers, single):
    """Program 2: the state split over (2, 4), saved by both processes
    (each writing its own ranks' shards) and restored bitwise; then one
    gauss-sharded step: the processes equal, and against the
    single-process gauss-sharded step loss rel <= 1e-6, xyz <= 1e-6."""
    reports, results = workers
    assert all(r["p2_checkpoint_bitwise"] is True for r in reports.values())
    a, b = results[0], results[1]
    assert a["losses"]["p2"] == b["losses"]["p2"]
    assert torch.equal(a["p2_xyz"], b["p2_xyz"])
    assert rel(a["losses"]["p2"], single["p2"]["loss"]) <= 1e-6
    assert float((a["p2_xyz"] - single["p2"]["xyz"]).abs().max()) <= 1e-6


def test_ring_v1_across_processes(workers, single):
    """Program 3 over (1, 8), 4 ranks a process: ring v1 within 1e-5 of
    the band route's loss, and each within 1e-6 (loss) of the port's
    single-process (1, 8) step, with xyz within 1e-6; the processes'
    states bitwise equal."""
    _, results = workers
    a, b = results[0], results[1]
    band, ring = a["losses"]["p3_band"], a["losses"]["p3_ring"]
    assert np.isfinite(ring)
    assert abs(ring - band) <= 1e-5 * max(abs(band), 1e-3)
    for key in ("p3_band", "p3_ring"):
        assert a["losses"][key] == b["losses"][key]
        assert torch.equal(a[key + "_xyz"], b[key + "_xyz"])
        assert rel(a["losses"][key], single[key]["loss"]) <= 1e-6
        assert float((a[key + "_xyz"] - single[key]["xyz"]).abs().max()) \
            <= 1e-6


def test_ring_v3_gauss_sharded_across_processes(workers, single):
    """Program 4: ring v3 with the gauss-sharded state on (1, 8): within
    1e-4 of the band loss, no reshard drops, within 1e-6 (loss) of the
    port's single-process v3 step, xyz within 1e-6."""
    reports, results = workers
    a = results[0]
    v3, band = a["losses"]["p4"], a["losses"]["p3_band"]
    assert np.isfinite(v3) and abs(v3 - band) <= 1e-4 * max(abs(band), 1e-3)
    assert all(r["p4"]["reshard_drops"] == 0.0 for r in reports.values())
    assert rel(v3, single["p4"]["loss"]) <= 1e-6
    assert float((a["p4_xyz"] - single["p4"]["xyz"]).abs().max()) <= 1e-6
    assert torch.equal(a["p4_xyz"], results[1]["p4_xyz"])


def test_four_processes_of_two_ranks(workers_4x2, single):
    """The collectives and programs 3 and 4 over (1, 8) held by four
    processes of 2 ranks each: the collectives' forward bitwise and
    gradients within 1e-6; every process's losses and xyz bitwise equal to
    process 0's; each program within 1e-6 (loss, relative) and xyz within
    1e-6 of the port's single-process (1, 8) step."""
    reports, results = workers_4x2
    for r in reports.values():
        assert r["mesh"] is None and r["ring_mesh"] == [1, 8]
        assert r["collectives"]["forward_bitwise"] is True
        assert r["collectives"]["grad_rel_max"] <= 1e-6
        assert r["p4"]["reshard_drops"] == 0.0
    a = results[0]
    assert sorted(a["losses"]) == ["p3_band", "p3_ring", "p4"]
    for key in ("p3_band", "p3_ring", "p4"):
        for b in results.values():
            assert b["losses"][key] == a["losses"][key]
            assert torch.equal(b[key + "_xyz"], a[key + "_xyz"])
        assert rel(a["losses"][key], single[key]["loss"]) <= 1e-6
        assert float((a[key + "_xyz"] - single[key]["xyz"]).abs().max()) \
            <= 1e-6


def test_four_processes_of_one_rank_over_2x2(workers_1x4, single_2x2):
    """Programs 1 and 2 over (2, 2) held by four processes of one rank: the
    tile rows {0, 1}, {2, 3} and the data columns {0, 2}, {1, 3} each
    exchange through a group of their two processes.  The collectives over
    each process's row: forward bitwise, gradients within 1e-6.  Every
    process's loss and xyz bitwise process 0's (the replicas); against the
    single-process (2, 2) steps loss rel <= 1e-6, xyz <= 1e-6; the
    checkpoint restored bitwise."""
    reports, results = workers_1x4
    for r in reports.values():
        assert r["mesh"] == [2, 2] and r["ring_mesh"] is None
        assert r["groups"] == [[0, 1], [0, 2], [1, 3], [2, 3]]
        assert r["collectives"]["forward_bitwise"] is True
        assert r["collectives"]["grad_rel_max"] <= 1e-6
        assert r["p2_checkpoint_bitwise"] is True
    a = results[0]
    for key in ("p1", "p2"):
        for b in results.values():
            assert b["losses"][key] == a["losses"][key]
            assert torch.equal(b[key + "_xyz"], a[key + "_xyz"])
        assert rel(a["losses"][key], single_2x2[key]["loss"]) <= 1e-6
        assert float((a[key + "_xyz"] - single_2x2[key]["xyz"]).abs()
                     .max()) <= 1e-6


def test_renders_over_processes(workers, workers_1x4, single, single_2x2):
    """Program 5: `make_sharded_render` and `make_gauss_sharded_render` give
    every process that holds a rank the whole image, alpha and depth,
    bitwise the single-process render on the same mesh: over (2, 2) of four
    processes (each renders its own data row), over (2, 4) of two, and over
    (1, 8) of two on the band route and through ring v1."""
    groups = ((workers_1x4, single_2x2, ("p5_mesh",)),
              (workers, single, ("p5_mesh", "p5_ring_mesh_band",
                                 "p5_ring_mesh_ring")))
    for (_, results), ref, keys in groups:
        for key in keys:
            for layout in ("replicated", "gauss_sharded"):
                want = ref[key][layout]
                assert want.shape[0] == 5 and bool(torch.isfinite(want).all())
                for res in results.values():
                    assert torch.equal(res[key][layout], want), (key, layout)


def test_grad_parity_over_processes(workers_1x4, single_2x2):
    """Program 6: `verify_shard_grad_parity` over (2, 2) of four processes,
    both layouts: each process against the autograd of its own rank gives
    the single-process check's deviation (within 1e-6 of it), far inside
    the check's 0.05."""
    reports, _ = workers_1x4
    for r in reports.values():
        for layout, worst in r["p6"].items():
            assert abs(worst - single_2x2["p6"][layout]) <= 1e-6
            assert worst < 1e-4


def test_a_process_without_a_rank(workers_1x4, single_2x2):
    """Program 7: the (1, 2) mesh of the first two ranks of four processes
    leaves processes 2 and 3 without a rank.  As the JAX package's step
    runs there and returns arrays with no value on them, theirs take part
    in no exchange and get None; processes 0 and 1 (whose tile axis is a
    group of the two) agree bitwise and lie within 1e-6 of the
    single-process (1, 2) step."""
    reports, results = workers_1x4
    assert [reports[k]["p7_ranks"] for k in range(4)] == [[0], [1], [], []]
    for k in (2, 3):
        assert reports[k]["p7"] is None and results[k]["p7_xyz"] is None
        assert "p7" not in results[k]["losses"]
    a, b = results[0], results[1]
    assert a["losses"]["p7"] == b["losses"]["p7"]
    assert torch.equal(a["p7_xyz"], b["p7_xyz"])
    assert rel(a["losses"]["p7"], single_2x2["p7"]["loss"]) <= 1e-6
    assert float((a["p7_xyz"] - single_2x2["p7"]["xyz"]).abs().max()) <= 1e-6


# ---- initialize_distributed and make_global_mesh, in this process --------

def test_initialize_without_a_topology_forms_no_group(monkeypatch):
    for k in TOPOLOGY:
        monkeypatch.delenv(k, raising=False)
    D.initialize_distributed()
    assert not dist.is_initialized()
    assert (D.process_index(), D.process_count()) == (0, 1)
    with pytest.raises(ValueError, match="needs all three"):
        D.initialize_distributed(coordinator_address="127.0.0.1:1")
    assert not dist.is_initialized()


def test_initialize_forms_a_group_once(monkeypatch):
    """From the environment, as JAX reads it; a repeat call, even with
    another topology, does nothing; the global mesh of one process is its
    own ranks."""
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("NUM_PROCESSES", "1")
    monkeypatch.setenv("PROCESS_ID", "0")
    try:
        D.initialize_distributed(backend="gloo", timeout=10)
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        D.initialize_distributed("127.0.0.1:1", 2, 1, timeout=1)
        assert (D.process_index(), D.process_count()) == (0, 1)
        mesh = D.make_global_mesh(local_devices=["cpu"] * 3)
        assert (mesh.data, mesh.tile) == (1, 3)
        assert mesh.local_ranks() == [0, 1, 2]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_initialize_raises_when_the_group_cannot_form():
    """An explicit two-process topology whose other process never comes
    raises within the timeout; nothing falls back to one process."""
    t0 = time.perf_counter()
    with pytest.raises(Exception):
        D.initialize_distributed(f"127.0.0.1:{free_port()}", 2, 0,
                                 backend="gloo", timeout=2)
    assert time.perf_counter() - t0 < 30
    assert not dist.is_initialized()


def test_make_global_mesh_defaults_and_checks(monkeypatch):
    """Unwired: tile defaults to this process's ranks and data to the
    rows they fill; data * tile above the ranks raises; without a card it
    raises unless the caller names CPU devices.  As process 2 of four with
    one rank each (the process count stood in for): every layout JAX's
    `make_global_mesh` forms forms here too, the first data x tile ranks
    process-major: (2, 2), whose axes each cross two processes, and
    (1, 2), which leaves this process without a rank; the over-count still
    raises."""
    mesh = D.make_global_mesh(local_devices=["cpu"] * 4)
    assert (mesh.data, mesh.tile) == (1, 4)
    assert (D.make_global_mesh(tile=2, local_devices=["cpu"] * 4).data) == 2
    mesh = D.make_global_mesh(data=1, tile=3, local_devices=["cpu"] * 4)
    assert len(mesh.devices) == 3
    with pytest.raises(ValueError, match="mesh over 4 ranks"):
        D.make_global_mesh(data=3, tile=2, local_devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            D.make_global_mesh()
    cpu, R = torch.device("cpu"), tmesh.Remote
    monkeypatch.setattr(D, "process_index", lambda: 2)
    monkeypatch.setattr(D, "gather_processes", lambda n: [n] * 4)
    mesh = D.make_global_mesh(2, 2, local_devices=["cpu"])
    assert mesh.devices == (R(0), R(1), cpu, R(3))
    assert mesh.local_ranks() == [2]
    assert mesh.data_devices(0) == [R(0), cpu]
    mesh = D.make_global_mesh(1, 2, local_devices=["cpu"])
    assert mesh.devices == (R(0), R(1)) and mesh.local_ranks() == []
    assert tmesh.processes_of(mesh.devices) == (0, 1)
    with pytest.raises(ValueError, match="mesh over 4 ranks"):
        D.make_global_mesh(3, 2, local_devices=["cpu"])


def test_remote_ranks_in_a_mesh():
    """A mesh names another process's ranks `Remote`: the per-axis device
    lists carry them.  The renderer takes such a mesh: this process renders
    the data row it holds whole (row 0, no exchange), bitwise the render
    over one process's (2, 2) mesh; a process with no rank gets None."""
    cpu = torch.device("cpu")
    mesh = tmesh.Mesh(2, 2, (cpu, cpu, tmesh.Remote(1), tmesh.Remote(1)))
    assert mesh.local_ranks() == [0, 1] and not mesh.is_local(2)
    assert mesh.data_devices(1) == [cpu, tmesh.Remote(1)]
    assert tmesh.spans_processes(mesh.devices)
    assert not tmesh.spans_processes(mesh.tile_devices(0))
    part = DS.small_setup()["mesh"]
    g, cam = part["state"].gaussians, part["cameras"][0]
    got = tsharded.make_sharded_render(part["settings"], mesh)(g, cam)
    want = tsharded.make_sharded_render(
        part["settings"], tmesh.make_mesh(2, 2, devices=["cpu"]))(g, cam)
    for k in ("image", "alpha", "depth"):
        assert torch.equal(got[k], want[k])
    rankless = tmesh.Mesh(1, 2, (tmesh.Remote(1), tmesh.Remote(2)))
    assert tsharded.make_sharded_render(part["settings"], rankless)(
        g, cam) is None


def test_sharded_checkpoint_in_one_process(tmp_path):
    """`save_sharded_checkpoint` / `load_sharded_checkpoint` over a (2, 2)
    mesh of one process: every shard back bit for bit; a template of
    another layout raises."""
    state = DS.small_setup()["mesh"]["state"]
    mesh = tmesh.make_mesh(2, 2, devices=["cpu"])
    split = tsharded.shard_train_state(state, mesh)
    tckpt.save_sharded_checkpoint(str(tmp_path), 3, split, mesh,
                                  extra={"n": 5})
    assert (tmp_path / "checkpoints" / "it0000003" / "state.p0.pt").exists()
    back, extra = tckpt.load_sharded_checkpoint(
        str(tmp_path), 3, tsharded.shard_train_state(state, mesh), mesh)
    assert extra == {"n": 5}
    whole = tsharded.gather_train_state(back, mesh)
    assert torch.equal(whole.gaussians.xyz, state.gaussians.xyz)
    assert torch.equal(whole.opt_state.nu["opacity"],
                       state.opt_state.nu["opacity"])
    other = tmesh.make_mesh(1, 4, devices=["cpu"])
    with pytest.raises(ValueError, match="saved over"):
        tckpt.load_sharded_checkpoint(
            str(tmp_path), 3, tsharded.shard_train_state(state, other), other)
