"""Dense BRIEF-256: gather-free binary description for the whole image.

The reference's default descriptor is plain (unrotated) BRIEF-256
(base_framepoint_generator.cpp:184-197, descriptor_type "BRIEF").  BRIEF's
fixed integer offsets admit a dense formulation in place of per-keypoint
gathers (orb.py):

    bit_b(x) = [ S(x + o1_b) < S(x + o2_b) ]     (S = 5x5 box sum of the image)

Each bit plane is one shifted-image comparison over the full image; 32
planes pack into one uint32 map, eight maps hold all 256 bits.  Keypoint
descriptors are then an 8-word row lookup — K x 8 loads instead of K x 3k.
S is the box SUM, not the mean: comparing sums orders pixels as the means
do, and the sum is computed without a division, so the bits are the same
on every backend and do not depend on matmul precision.

Orientation invariance is lost (as in the reference's default); the
rotation-aware gather path remains available as descriptor_type "ORB256".
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from vslam_tpu.frontend import brief_gpu
from vslam_tpu.frontend.orb import PATTERN_RADIUS, _make_pattern, box_blur, box_sum
from vslam_tpu.ops import hamming

# Integer BRIEF offsets from the same seeded pattern as the ORB path.
_PAT = np.round(_make_pattern()).astype(np.int32)  # (256, 2, 2) [bit, pt, (dr, dc)]


def planes_from_pattern(smooth: jnp.ndarray, pat: np.ndarray) -> jnp.ndarray:
    """(H, W) SMOOTHED image -> (8, H, W) uint32 packed BRIEF bit planes.

    pat: (256, 2, 2) static integer offsets [bit, point, (dr, dc)].  Bit j
    of word w is [ S(x + o1) < S(x + o2) ] for pattern row 32 * w + j; taps
    outside the image read zero.  The 512 static slices, the compares and
    the shift-or packing fuse into one elementwise loop.  This is the form
    every platform but CUDA runs, and the reference of brief_gpu's kernel.
    """
    H, W = smooth.shape
    R = PATTERN_RADIUS
    padded = jnp.pad(smooth, R)

    def tap(dr, dc):
        return jax.lax.slice(padded, (R + dr, R + dc), (R + dr + H, R + dc + W))

    words = []
    for w in range(8):
        acc = jnp.zeros((H, W), jnp.uint32)
        for j in range(32):
            (dr1, dc1), (dr2, dc2) = pat[w * 32 + j].tolist()
            bit = (tap(dr1, dc1) < tap(dr2, dc2)).astype(jnp.uint32)
            acc = acc | (bit << np.uint32(j))
        words.append(acc)
    return jnp.stack(words)


def planes_numpy(smooth: np.ndarray, pat: np.ndarray) -> np.ndarray:
    """Plain numpy reference of planes_from_pattern (the test oracle)."""
    H, W = smooth.shape
    R = PATTERN_RADIUS
    sp = np.zeros((H + 2 * R, W + 2 * R), np.float32)
    sp[R:-R, R:-R] = smooth
    out = np.zeros((8, H, W), np.uint32)
    for w in range(8):
        for j in range(32):
            (dr1, dc1), (dr2, dc2) = pat[w * 32 + j]
            a = sp[R + dr1 : R + dr1 + H, R + dc1 : R + dc1 + W]
            c = sp[R + dr2 : R + dr2 + H, R + dc2 : R + dc2 + W]
            out[w] |= (a < c).astype(np.uint32) << np.uint32(j)
    return out


@jax.jit
def dense_bit_planes(img: jnp.ndarray) -> jnp.ndarray:
    """(H, W) raw image -> (8, H, W) uint32 packed BRIEF bit planes.

    On a CUDA GPU the planes come from the Pallas-Triton tile kernel
    (brief_gpu.py): it is bit-identical to planes_from_pattern, and XLA's
    fusion of the 512 shifted taps was the front-end's largest kernel on
    the H100 (PERF.md).  Every other platform runs planes_from_pattern.
    """
    return jax.lax.platform_dependent(
        box_sum(img, radius=2),
        cuda=lambda s: brief_gpu.planes_from_pattern_gpu(s[None], _PAT)[0],
        default=lambda s: planes_from_pattern(s, _PAT),
    )


def describe_dense(img: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Packed descriptors at (rounded) keypoint coordinates.

    img: (H, W) f32; uv: (K, 2) [col, row].  Returns (K, 8) uint32.
    """
    return _gather_planes(dense_bit_planes(img), img.shape, uv)


def _gather_planes(planes, shape, uv):
    H, W = shape
    c = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, W - 1)
    r = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, H - 1)
    return planes[:, r, c].T  # (K, 8)


def dense_planes(img: jnp.ndarray) -> jnp.ndarray:
    """Packed BRIEF bit planes for ONE image: (8, H, W) uint32 (the RGB-D
    pipeline's variant of dense_planes_pair — depth mode has no right
    image to describe)."""
    return dense_bit_planes(img)


def dense_planes_pair(img_l, img_r) -> jnp.ndarray:
    """Packed BRIEF bit planes for a stereo pair: (2, 8, H, W) uint32.

    Keeping the planes around lets later stages re-describe ARBITRARY
    pixel positions with a single gather — the mechanism behind landmark
    recovery (reference recoverPoints re-extracts descriptors at projected
    landmark coordinates, stereo_framepoint_generator.cpp:683-869).
    """
    return jnp.stack([dense_bit_planes(img_l), dense_bit_planes(img_r)])


def gather_descriptors(planes: jnp.ndarray, shape, uv: jnp.ndarray) -> jnp.ndarray:
    """Descriptors at (rounded) pixel coordinates from precomputed planes."""
    return _gather_planes(planes, shape, uv)


# ---------------------------------------------------------------------------
# Rotated-pattern-bank BRIEF ("BRIEF256R"): orientation-aware description
# from integer pattern banks.
# ---------------------------------------------------------------------------
#
# ORB's steered BRIEF rotates the test pattern by each keypoint's
# orientation.  The rotated-bank formulation quantizes orientation into
# N_ROT_BANKS bins (OpenCV ORB quantizes to 12 degrees itself), each bank
# being the seeded pattern pre-rotated to integer offsets.  A keypoint
# takes the bank matching its local orientation, read from a dense
# smoothed-gradient orientation map (the first-moment direction, which
# coincides with ORB's intensity-centroid direction for locally linear
# intensity).  Its descriptor equals bank b's dense planes
# (planes_from_pattern(smooth, _ROT_PATS[b])) read at the keypoint, but is
# taken with K x 512 integer-offset loads instead of 16 full-image banks.

N_ROT_BANKS = 16


def _rotated_int_patterns(n_banks: int = N_ROT_BANKS) -> np.ndarray:
    """(B, 256, 2, 2) integer offsets: the seeded BRIEF pattern rotated by
    each bank angle (same steering convention as orb.describe)."""
    raw = _make_pattern()  # float (256, 2, 2) [(dr, dc)]
    out = np.zeros((n_banks, 256, 2, 2), np.int32)
    for b in range(n_banks):
        th = 2.0 * np.pi * b / n_banks
        ct, st = np.cos(th), np.sin(th)
        dr, dc = raw[:, :, 0], raw[:, :, 1]
        dr_r = st * dc + ct * dr
        dc_r = ct * dc - st * dr
        out[b] = np.clip(
            np.round(np.stack([dr_r, dc_r], axis=-1)),
            -PATTERN_RADIUS, PATTERN_RADIUS,
        ).astype(np.int32)
    return out


_ROT_PATS = _rotated_int_patterns()


def orientation_bin_map(smooth: jnp.ndarray,
                        n_banks: int = N_ROT_BANKS,
                        grad_radius: int = 7) -> jnp.ndarray:
    """(H, W) int32 orientation bins from heavily-smoothed gradients."""
    gx = 0.5 * (jnp.roll(smooth, -1, axis=1) - jnp.roll(smooth, 1, axis=1))
    gy = 0.5 * (jnp.roll(smooth, -1, axis=0) - jnp.roll(smooth, 1, axis=0))
    Sx = box_blur(gx, grad_radius)
    Sy = box_blur(gy, grad_radius)
    theta = jnp.arctan2(Sy, Sx)  # [-pi, pi]
    b = jnp.round(theta * (n_banks / (2.0 * np.pi))).astype(jnp.int32)
    return jnp.mod(b, n_banks)


def describe_dense_rotated(img: jnp.ndarray, uv: jnp.ndarray,
                           n_banks: int = N_ROT_BANKS) -> jnp.ndarray:
    """Oriented packed descriptors at keypoints via rotated pattern banks.

    img: (H, W) f32 (RAW image; smoothing happens here).
    Returns (K, 8) uint32, bit-identical to gathering each keypoint's bank
    planes (planes_from_pattern) at its rounded, clipped coordinates.
    """
    H, W = img.shape
    R = PATTERN_RADIUS
    smooth = box_sum(img, radius=2)
    bins_map = orientation_bin_map(smooth, n_banks)
    c = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, W - 1)
    r = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, H - 1)
    pat = jnp.asarray(_rotated_int_patterns(n_banks))[bins_map[r, c]]
    padded = jnp.pad(smooth, R)  # zero taps off the image, as the planes
    vals = padded[R + r[:, None, None] + pat[..., 0],
                  R + c[:, None, None] + pat[..., 1]]  # (K, 256, 2)
    return hamming.pack_bits(vals[..., 0] < vals[..., 1])
