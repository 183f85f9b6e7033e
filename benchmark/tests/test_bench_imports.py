"""The import check, by whole top-level names: JAX and the JAX package are
caught, the measured package (whose name begins with the JAX package's)
is not; the reference loads neither nor the measured package."""

import subprocess
import sys

from conftest import BENCH, ROOT

from harness import env


def test_names_are_compared_whole():
    mods = {"mini3dgs_tpu_torch": 1, "mini3dgs_tpu_torch.ops.renderer": 1,
            "jaxtyping": 1, "numpy": 1}
    assert env.loaded(modules=mods) == []
    assert env.loaded(modules=dict(mods, **{"jax.numpy": 1})) == ["jax"]
    assert env.loaded(modules=dict(mods, **{"mini3dgs_tpu.ops": 1})) == \
        ["mini3dgs_tpu"]


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
         + code + "\nprint(' '.join(sorted({m.split('.')[0] "
         "for m in sys.modules})))"],
        capture_output=True, text=True, check=True, timeout=120)
    return set(out.stdout.split())


def test_reference_imports_nothing_of_the_program():
    tops = _loaded_after("import reference.train, reference.raster, "
                         "reference.projection")
    assert not tops & {"jax", "jaxlib", "flax", "mini3dgs_tpu",
                       "mini3dgs_tpu_torch", "harness"}


def test_a_run_loads_no_jax():
    # few threads, as the other tests: on a busy host more only contend;
    # a window long enough to reach the checked frames on a slow host
    code = (
        "import time, torch, conftest\n"
        "import run\n"
        "torch.set_num_threads(4)\n"
        "cell = conftest.tiny_cell('mipnerf360_outdoor.render', n=500)\n"
        "run.run(cell, 7, 3.0, False, torch.device('cpu'), "
        "time.perf_counter())")
    code = f"sys.path.insert(0, {str(BENCH / 'tests')!r})\n" + code
    tops = _loaded_after(code)
    assert "mini3dgs_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "mini3dgs_tpu"}
