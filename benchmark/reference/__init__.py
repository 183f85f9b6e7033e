"""The benchmark's plain reference of a 3D Gaussian Splatting step.

Plain PyTorch, on any device and in any float dtype, written from frozen
copies of the plain code of the measured package: EWA projection with
spherical harmonics up to degree 3 (`projection.py`), tile binning and
front-to-back compositing with the early stop at A >= 0.995, computed tile
by tile in blocks (`raster.py`), L1 + D-SSIM, and Adam with the cosine
position schedule (`train.py`).  The backward is autograd's, not a
hand-derived one.

It imports nothing of the measured package, of the JAX package or of the
harness: it takes plain tensors (the Gaussians and cameras the benchmark
made) and the recipe's settings, and works out everything else itself.
"""
