"""Batched rotation-aware binary descriptors (oriented BRIEF / ORB-class).

Replaces the reference's OpenCV DescriptorExtractor selection
(src/framepoint_generation/base_framepoint_generator.cpp:184-224, default
BRIEF/ORB at 256 bits).  All keypoints of a frame are described in one
vmapped program: orientation by intensity centroid (ORB's moment method)
over a radius-15 circular patch, then 256 smoothed-pixel pair comparisons
on a pattern rotated by the orientation.

The test pattern is a fixed seeded Gaussian BRIEF pattern (sigma = patch/5,
the classic BRIEF-32 construction) rather than OpenCV's learned table:
bit-exact OpenCV compatibility is not a goal — matching behaviour is
validated statistically against OpenCV ORB (distance distributions for
matching vs non-matching patches, SURVEY.md §7.3) and end-to-end on ATE.
Descriptors are packed uint32[8] for the Hamming ops (ops/hamming.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from vslam_tpu.ops import hamming

PATCH_RADIUS = 15  # orientation patch radius (ORB standard 31x31 patch)
PATTERN_RADIUS = 13  # BRIEF pattern extent
N_BITS = hamming.DESC_BITS


def _make_pattern(seed: int = 7) -> np.ndarray:
    """(256, 2, 2) [pair, point, (dr, dc)] Gaussian BRIEF pattern, clipped."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATTERN_RADIUS + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(N_BITS, 2, 2))
    return np.clip(pts, -PATTERN_RADIUS, PATTERN_RADIUS).astype(np.float32)


PATTERN = jnp.asarray(_make_pattern())  # (256, 2, 2)

# Circular orientation patch offsets (precomputed dense disk mask).
_yy, _xx = np.mgrid[-PATCH_RADIUS : PATCH_RADIUS + 1, -PATCH_RADIUS : PATCH_RADIUS + 1]
_DISK = (_yy**2 + _xx**2 <= PATCH_RADIUS**2).astype(np.float32)
DISK = jnp.asarray(_DISK)
DISK_DR = jnp.asarray(_yy.astype(np.float32))
DISK_DC = jnp.asarray(_xx.astype(np.float32))


def box_sum(img: jnp.ndarray, radius: int = 2) -> jnp.ndarray:
    """Separable (2r+1)^2 box SUM, edge-replicated: rows, then columns,
    each added in a fixed order with no division, so every backend
    computes the same bits (a division by a constant may become a
    multiplication by its reciprocal on one backend and not another).

    Written as shifted-slice sums, NOT lax.conv: the shift-adds fuse into
    one elementwise pass, where a single-channel convolution would go to
    a matmul-shaped library kernel."""
    k = 2 * radius + 1
    H, W = img.shape
    pad = jnp.pad(img, radius, mode="edge")
    rows = sum(pad[i : i + H, :] for i in range(k))  # (H, W + 2r)
    return sum(rows[:, j : j + W] for j in range(k))


def box_blur(img: jnp.ndarray, radius: int = 2) -> jnp.ndarray:
    """Separable box blur (ORB smooths with a box filter over the integral
    image); edge-replicated, normalized."""
    k = 2 * radius + 1
    return box_sum(img, radius) / (k * k)


def _bilinear(img: jnp.ndarray, r: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample img at float (r, c); clamped to bounds."""
    H, W = img.shape
    r = jnp.clip(r, 0.0, H - 1.001)
    c = jnp.clip(c, 0.0, W - 1.001)
    r0 = jnp.floor(r).astype(jnp.int32)
    c0 = jnp.floor(c).astype(jnp.int32)
    fr = r - r0
    fc = c - c0
    i00 = img[r0, c0]
    i01 = img[r0, c0 + 1]
    i10 = img[r0 + 1, c0]
    i11 = img[r0 + 1, c0 + 1]
    return (
        i00 * (1 - fr) * (1 - fc)
        + i01 * (1 - fr) * fc
        + i10 * fr * (1 - fc)
        + i11 * fr * fc
    )


def orientations(img: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation per keypoint: theta = atan2(m01, m10).

    uv: (K, 2) [col, row] f32.  Returns (K,) angles in radians.
    """

    def one(kp):
        c, r = kp[0], kp[1]
        vals = _bilinear(img, r + DISK_DR, c + DISK_DC) * DISK
        m10 = jnp.sum(vals * DISK_DC)
        m01 = jnp.sum(vals * DISK_DR)
        return jnp.arctan2(m01, m10)

    return jax.vmap(one)(uv)


@jax.jit
def describe(img: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Compute packed 256-bit descriptors for keypoints.

    img: (H, W) f32 grayscale.  uv: (K, 2) [col, row].
    Returns (K, 8) uint32.  Invalid keypoints produce garbage rows that the
    caller masks — keeping the program shape-static.
    """
    smooth = box_blur(img, radius=2)
    theta = orientations(smooth, uv)
    cos_t = jnp.cos(theta)
    sin_t = jnp.sin(theta)

    def one(kp, ct, st):
        c, r = kp[0], kp[1]
        # rotate pattern offsets: (dr, dc) -> steered by theta
        dr = PATTERN[:, :, 0]
        dc = PATTERN[:, :, 1]
        dr_rot = st * dc + ct * dr
        dc_rot = ct * dc - st * dr
        vals = _bilinear(smooth, r + dr_rot, c + dc_rot)  # (256, 2)
        bits = (vals[:, 0] < vals[:, 1]).astype(jnp.uint32)
        return bits

    bits = jax.vmap(one)(uv, cos_t, sin_t)  # (K, 256)
    return hamming.pack_bits(bits)
