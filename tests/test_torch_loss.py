"""The port's photometric loss against the JAX package on identical numpy
images: the Gaussian window, SSIM, D-SSIM, `gaussian_loss`, and the
gradient of the loss with respect to the rendered image.

Tolerance: the blur and the window agree to atol 1e-6 (both sides sum the
same 11-tap float32 stencil in the same order).  The scalar values agree
to atol 3e-6: the final mean over the image is a sequential float32 sum in
XLA's CPU reduction and a pairwise one in PyTorch, and against a float64
evaluation JAX is off by 1.2e-6 to 1.6e-6 on these images and the port by
under 1e-7 (which the tests also assert).  Gradients: 1e-5 of the
gradient's largest magnitude."""

VALUE_ATOL = 3e-6

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini3dgs_tpu.core import loss as jloss
from mini3dgs_tpu_torch.core import loss as tloss
from tests.test_torch_core import t2n


def image_pair(shape, seed):
    """A smooth random image and a noisy copy, in [0, 1]."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, shape).astype(np.float32)
    for axis in (-1, -2):  # smooth, so SSIM is neither 0 nor 1 everywhere
        base = (base + np.roll(base, 1, axis) + np.roll(base, -1, axis)) / 3
    noisy = np.clip(base + rng.normal(0, 0.1, shape), 0, 1)
    return base.astype(np.float32), noisy.astype(np.float32)


def test_gaussian_window_matches_jax():
    np.testing.assert_allclose(t2n(tloss._gaussian_window(11)),
                               np.asarray(jloss._gaussian_window(11)),
                               atol=1e-7)


@pytest.mark.parametrize("shape", [(3, 40, 56), (2, 3, 32, 32), (3, 9, 7)])
def test_ssim_matches_jax(shape):
    """[C,H,W], batched, and an image smaller than the 11-tap window."""
    a, b = image_pair(shape, seed=sum(shape))
    want = float(jloss.ssim(jnp.asarray(a), jnp.asarray(b)))
    got = float(tloss.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert 0.05 < want < 0.95
    np.testing.assert_allclose(got, want, atol=VALUE_ATOL)
    exact = float(tloss.ssim(torch.from_numpy(a).double(),
                             torch.from_numpy(b).double()))
    np.testing.assert_allclose(got, exact, atol=1e-7)
    np.testing.assert_allclose(
        float(tloss.dssim(torch.from_numpy(a), torch.from_numpy(b))),
        float(jloss.dssim(jnp.asarray(a), jnp.asarray(b))), atol=VALUE_ATOL)
    same = float(tloss.ssim(torch.from_numpy(a), torch.from_numpy(a)))
    np.testing.assert_allclose(same, 1.0, atol=1e-5)


def test_blur_matches_jax():
    a, _ = image_pair((1, 3, 20, 24), seed=2)
    g = np.array(jloss._gaussian_window(11))
    want = np.asarray(jloss._blur(jnp.asarray(a), jnp.asarray(g)))
    got = t2n(tloss._blur(torch.from_numpy(a), torch.from_numpy(g)))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("lambda_dssim", [0.2, 0.0, 1.0])
def test_gaussian_loss_and_gradient_match_jax(lambda_dssim):
    target, pred = image_pair((3, 40, 56), seed=5)
    (jt, jparts), jgrad = jax.value_and_grad(
        lambda p: jloss.gaussian_loss(p, jnp.asarray(target), lambda_dssim),
        has_aux=True)(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_(True)
    tt, tparts = tloss.gaussian_loss(tp, torch.from_numpy(target),
                                     lambda_dssim)
    assert set(tparts) == set(jparts) == {"l1", "dssim", "total_loss"}
    np.testing.assert_allclose(float(tt.detach()), float(jt),
                               atol=VALUE_ATOL)
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k].detach()),
                                   float(jparts[k]), atol=VALUE_ATOL,
                                   err_msg=k)
    tt.backward()
    want = np.asarray(jgrad)
    np.testing.assert_allclose(t2n(tp.grad), want,
                               atol=1e-5 * np.abs(want).max())
