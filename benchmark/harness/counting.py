"""What a step needs, counted from its inputs: the card's peaks, the raster
kernels' operations and bytes (frozen from the measured package's on-card
smoke test, over the pair classes that the benchmark's own reference
counts), and the float32 operations of a whole step for `mfu`.

An operation is a float32 add, multiply or compare; a fused multiply-add
counts two; exp, sqrt and a true division count eight each.  A count is
what these inputs need, not what an implementation happens to do: work
that a closed gate makes unnecessary counts nothing.
"""

from __future__ import annotations

# The card's published peaks (NVIDIA H100 SXM data sheet): HBM3 bytes/s and
# float32 operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12

# Per pixel x instance pair, by how far the pair gets.  Every pair whose
# gate is open: the gate test 2; dx, dy 2; the quadratic form 8; exp 8;
# min(., 1) 1; the w >= 1e-5 test 1.
PAIR_TEST_OPS = 22
# Forward, further, where w >= 1e-5: op*w 1; min 1; T*alpha 1; four
# accumulator FMAs and one add 9; the T update 2.
FWD_LIVE_OPS = 14
# Backward, further, where w >= 1e-5: op*w 1; min 1; T*alpha 1; u 8; the
# running sum 2; four colour FMAs 8; the two tests of op*w 2; T update 2.
BWD_LIVE_OPS = 25
# Backward, further, where 0 < op*w < 1: d_alpha 13; d_op 2; the w < 1
# test 1.
BWD_ALPHA_OPS = 16
# Backward, further, where also w < 1: d_lw 2; the five geometric terms 20.
BWD_GEOM_OPS = 22
STREAM_BYTES = 40   # an instance: x, y, three conic terms, op, rgb, depth
N_ACC_ROWS = 8      # accumulator rows a forward launch writes

# Per Gaussian, forward.  Projection: the view transform 18; 1/Z and its
# square 10; the pixel means 6; three exp of the log-scales 24; the
# quaternion's norm and division 48 and its rotation matrix 30; the nine
# terms of Rv R S 54; J 6; the six covariance dots 30; the 2D covariance
# 24; its inverse 15; the eigenvalue and radius 30; the cull 10; the
# sigmoid of the opacity 17; the two contour extents 22.
PROJECTION_FWD_OPS = 344
# SH degree 3: the view direction and its norm 41; the 15 basis products
# 25; 16 coefficients x 3 channels as FMAs 96; + 0.5 and the clamp 6.
SH3_FWD_OPS = 168
# Reverse mode costs about two operations for each forward one (a
# product's adjoint is two products, an add's two copies).
BACKWARD_PER_FORWARD = 2
# Per pixel: the epilogue, rgb + (1 - A) bg and the clamp, 3 channels x 5.
EPILOGUE_FWD_OPS = 15
# Per pixel and channel: L1 3; the five SSIM maps' products 3; two
# 11-tap blurs of five maps as FMAs 220; the SSIM formula 22 and its
# division 8; the clamp and the mean 2.
LOSS_FWD_OPS = 258
# Per parameter element: the dead-slot mask 1; the first moment 3; the
# second 4; two bias corrections as divisions 16; sqrt 8; + eps 1; the
# division 8; the rate 2; the update 1.
ADAM_OPS = 44
# Per Gaussian: the densify statistic, the norm of the 2D gradient and two
# accumulations.
STATS_OPS = 14
PARAMS_PER_GAUSSIAN = 3 + 3 + 45 + 3 + 4 + 1


def bound_s(n_ops: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the float32 rate and bytes over the memory rate."""
    return max(n_ops / PEAK_FP32_OPS_PER_S, n_bytes / PEAK_BYTES_PER_S)


def raster_fwd_need(pairs: dict, n_inst: int, T: int, P: int):
    """(operations, bytes) of one forward raster launch: the stream read
    once, the tile ranges, the accumulators written once."""
    ops = PAIR_TEST_OPS * pairs["open"] + FWD_LIVE_OPS * pairs["live"]
    return ops, STREAM_BYTES * n_inst + 8 * T + 4 * N_ACC_ROWS * T * P


def raster_bwd_need(pairs: dict, n_inst: int, T: int, P: int):
    """(operations, bytes) of one backward raster launch: the stream and
    its gradient, the ranges, and the five live rows of the accumulators'
    cotangent and of the accumulators."""
    ops = (PAIR_TEST_OPS * pairs["open"] + BWD_LIVE_OPS * pairs["live"]
           + BWD_ALPHA_OPS * pairs["alpha"] + BWD_GEOM_OPS * pairs["geom"])
    return ops, 2 * STREAM_BYTES * n_inst + 8 * T + 2 * 4 * 5 * T * P


def render_ops(pairs: dict, n_gauss: int, n_pixels: int) -> float:
    """Float32 operations one frame needs: projection and SH 3 of every
    Gaussian, the forward raster, the epilogue."""
    return ((PROJECTION_FWD_OPS + SH3_FWD_OPS) * n_gauss
            + PAIR_TEST_OPS * pairs["open"] + FWD_LIVE_OPS * pairs["live"]
            + EPILOGUE_FWD_OPS * n_pixels)


def train_ops(pairs: dict, n_gauss: int, n_pixels: int) -> float:
    """Float32 operations one train step needs: the frame forward and
    backward, L1 + D-SSIM forward and backward, Adam over every parameter
    and the densify statistic."""
    per_gauss = (PROJECTION_FWD_OPS + SH3_FWD_OPS) \
        * (1 + BACKWARD_PER_FORWARD) + ADAM_OPS * PARAMS_PER_GAUSSIAN \
        + STATS_OPS
    per_pixel = (EPILOGUE_FWD_OPS + 3 * LOSS_FWD_OPS) \
        * (1 + BACKWARD_PER_FORWARD)
    fwd, _ = raster_fwd_need(pairs, 0, 0, 0)
    bwd, _ = raster_bwd_need(pairs, 0, 0, 0)
    return per_gauss * n_gauss + per_pixel * n_pixels + fwd + bwd
