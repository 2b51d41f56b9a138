"""FAST-9/16 corner detection as a whole-image batched array program.

Replaces the reference's per-region OpenCV detector grid
(src/framepoint_generation/base_framepoint_generator.cpp:229-459): instead
of R independent cv::FastFeatureDetector calls over image sub-regions with
per-region threshold controllers, the whole image is processed in one
fused XLA program and spatial regularization is per-cell argmax binning
(one keypoint per bin cell, the reference's `bin_size_pixels` grid,
base_framepoint_generator.cpp:303-322) followed by a global top-K to a
fixed capacity.  The dynamic threshold controller stays on the host and
feeds the threshold in as a scalar array (no recompiles).

Segment test: a pixel is a corner when >= 9 contiguous pixels of the
16-pixel Bresenham circle are all brighter than center+t or all darker
than center-t.  Score = max over the two polarities of the summed
threshold excess (the standard GPU-FAST approximation of OpenCV's
max-threshold score).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3, clockwise from 12 o'clock: (row, col) offsets.
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)
ARC_LEN = 9


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (SoA, masked)."""

    uv: jnp.ndarray  # (K, 2) f32 [u=col, v=row] — always LEVEL-0 coords
    score: jnp.ndarray  # (K,) f32 detector response
    valid: jnp.ndarray  # (K,) bool
    octave: jnp.ndarray = None  # (K,) int32 pyramid level (0 = full res)


def _shifted_stack(img: jnp.ndarray) -> jnp.ndarray:
    """(H, W) -> (16, H, W): circle neighbor values per pixel (zero-padded
    borders; border cells are masked out downstream)."""
    pad = 3
    padded = jnp.pad(img, pad)
    H, W = img.shape
    views = [
        jax.lax.dynamic_slice(padded, (pad + int(dr), pad + int(dc)), (H, W))
        for dr, dc in CIRCLE
    ]
    return jnp.stack(views, axis=0)


def fast_score_map(
    img: jnp.ndarray, threshold: jnp.ndarray, arc_len: int = ARC_LEN
) -> jnp.ndarray:
    """Per-pixel FAST-N/16 corner score; 0 where not a corner.

    img: (H, W) f32.  threshold: scalar f32 (dynamic — host-controlled).
    arc_len: required contiguous run (9 = FAST-9, 12 = FAST-12).
    """
    circ = _shifted_stack(img)  # (16, H, W)
    center = img[None]
    bright = circ > center + threshold
    dark = circ < center - threshold

    def arc_exists(mask):
        # contiguous run >= arc_len on a ring: wrap-extend then window-sum.
        ext = jnp.concatenate([mask, mask[: arc_len - 1]], axis=0).astype(jnp.int32)
        cs = jnp.cumsum(ext, axis=0)
        cs = jnp.concatenate([jnp.zeros_like(cs[:1]), cs], axis=0)
        wsum = cs[arc_len:] - cs[:-arc_len]  # (16, H, W)
        return jnp.max(wsum, axis=0) == arc_len

    is_corner = arc_exists(bright) | arc_exists(dark)
    # Sequential accumulation in circle order: a fixed summation order, so
    # the score does not depend on how a backend would tree-reduce a sum.
    bright_excess = jnp.zeros_like(img)
    dark_excess = jnp.zeros_like(img)
    hi = img + threshold
    lo = img - threshold
    for kk in range(16):
        bright_excess = bright_excess + jnp.maximum(circ[kk] - hi, 0.0)
        dark_excess = dark_excess + jnp.maximum(lo - circ[kk], 0.0)
    score = jnp.maximum(bright_excess, dark_excess)
    return jnp.where(is_corner, score, 0.0)


def _structure_tensor(img: jnp.ndarray, radius: int = 2):
    """Smoothed image-gradient outer products (A=IxIx, B=IxIy, C=IyIy).

    Intensities are normalized to [0,1] so Harris/Shi-Tomasi responses live
    on a stable scale regardless of the 8-bit input range.
    """
    from vslam_tpu.frontend.orb import box_blur

    x = img * (1.0 / 255.0)
    # Central differences (Scharr-free: adequate for corner scoring); the
    # roll wraparound rows/cols are zeroed (borders are masked downstream
    # anyway, but wrapped gradients would leak into the blur window).
    Ix = 0.5 * (jnp.roll(x, -1, axis=1) - jnp.roll(x, 1, axis=1))
    Iy = 0.5 * (jnp.roll(x, -1, axis=0) - jnp.roll(x, 1, axis=0))
    Ix = Ix.at[:, 0].set(0.0).at[:, -1].set(0.0)
    Iy = Iy.at[0, :].set(0.0).at[-1, :].set(0.0)
    A = box_blur(Ix * Ix, radius)
    B = box_blur(Ix * Iy, radius)
    C = box_blur(Iy * Iy, radius)
    return A, B, C


# Scale factor putting typical strong-corner responses into the same ~5-100
# range the FAST threshold controller operates in.
_HARRIS_SCALE = 5.0e4
_GFTT_SCALE = 5.0e3


def harris_score_map(img: jnp.ndarray, threshold: jnp.ndarray) -> jnp.ndarray:
    """Harris corner response det(M) - k*trace(M)^2 (reference detector
    option "GFTT"/Harris family; pure elementwise work — no OpenCV).
    """
    A, B, C = _structure_tensor(img)
    k = 0.04
    det = A * C - B * B
    tr = A + C
    score = (det - k * tr * tr) * _HARRIS_SCALE
    return jnp.where(score > threshold, score, 0.0)


def gftt_score_map(img: jnp.ndarray, threshold: jnp.ndarray) -> jnp.ndarray:
    """Shi-Tomasi (good-features-to-track) min-eigenvalue response."""
    A, B, C = _structure_tensor(img)
    half_tr = 0.5 * (A + C)
    rad = jnp.sqrt(jnp.maximum(0.25 * (A - C) ** 2 + B * B, 0.0))
    score = (half_tr - rad) * _GFTT_SCALE
    return jnp.where(score > threshold, score, 0.0)


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    radius = int(np.ceil(3.0 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gauss_blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Separable Gaussian blur, (H, W) f32 -> (H, W) f32 (static sigma)."""
    k = jnp.asarray(_gauss_kernel1d(sigma))
    n = k.shape[0]
    x = img[None, None]  # NCHW
    x = jax.lax.conv_general_dilated(
        x, k.reshape(1, 1, 1, n), (1, 1), [(0, 0), (n // 2, n // 2)]
    )
    x = jax.lax.conv_general_dilated(
        x, k.reshape(1, 1, n, 1), (1, 1), [(n // 2, n // 2), (0, 0)]
    )
    return x[0, 0]


# DoG contrast (in 8-bit intensity units) -> detector-threshold range
# (~5-100, shared with FAST so the dynamic threshold controller transfers).
_DOG_SCALE = 12.0
# Intra-octave scale ladder (SIFT-standard k = 2^(1/2) spacing, 5 levels
# -> 4 DoG bands -> extrema tested on the 2 interior bands).
_DOG_SIGMAS = (1.0, 1.414, 2.0, 2.828, 4.0)


def dog_score_map(img: jnp.ndarray, threshold: jnp.ndarray) -> jnp.ndarray:
    """Difference-of-Gaussians scale-space extremum response — the
    SIFT/KAZE-class float blob detector of the fork's pluggable family
    (reference base_framepoint_generator.cpp:94-113 wraps
    cv::xfeatures2d::SIFT; here the scale-space extremum search runs as
    stacked separable convs + one 3D max/min window).

    A pixel scores when it is a 26-neighborhood (3x3x3 in x, y, scale)
    extremum of the DoG stack on an interior band and its contrast clears
    the (host-controlled) threshold.  Multi-OCTAVE coverage comes from the
    shared pyramid machinery (detect_keypoints octaves)."""
    g = [gauss_blur(img, s) for s in _DOG_SIGMAS]
    D = jnp.stack([g[i + 1] - g[i] for i in range(len(g) - 1)])  # (S, H, W)
    maxn = jax.lax.reduce_window(
        D, -jnp.inf, jax.lax.max, (3, 3, 3), (1, 1, 1), "SAME"
    )
    minn = jax.lax.reduce_window(
        D, jnp.inf, jax.lax.min, (3, 3, 3), (1, 1, 1), "SAME"
    )
    is_ext = ((D >= maxn) & (D > 0)) | ((D <= minn) & (D < 0))
    # Edge rejection (SIFT's principal-curvature ratio test): a step edge
    # is a scale-space extremum too, but its spatial Hessian has one
    # dominant curvature — reject tr^2/det above ((r+1)^2)/r, r = 10.
    Dxx = jnp.roll(D, -1, axis=2) + jnp.roll(D, 1, axis=2) - 2.0 * D
    Dyy = jnp.roll(D, -1, axis=1) + jnp.roll(D, 1, axis=1) - 2.0 * D
    Dxy = 0.25 * (
        jnp.roll(jnp.roll(D, -1, axis=1), -1, axis=2)
        + jnp.roll(jnp.roll(D, 1, axis=1), 1, axis=2)
        - jnp.roll(jnp.roll(D, -1, axis=1), 1, axis=2)
        - jnp.roll(jnp.roll(D, 1, axis=1), -1, axis=2)
    )
    tr = Dxx + Dyy
    det = Dxx * Dyy - Dxy * Dxy
    r = 10.0
    not_edge = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
    score = jnp.where(is_ext & not_edge, jnp.abs(D) * _DOG_SCALE, 0.0)
    # Interior bands only (the outer bands lack a scale neighbor).
    score = jnp.max(score[1:-1], axis=0)
    return jnp.where(score > threshold, score, 0.0)


# ---------------------------------------------------------------------------
# KAZE-class nonlinear-scale-space detector (reference wraps cv::KAZE /
# cv::AKAZE, base_framepoint_generator.cpp:28-49,73-91).  Linear (Gaussian)
# scale space blurs across object boundaries; KAZE evolves the image by
# Perona-Malik nonlinear diffusion  dL/dt = div(g(|grad L|) grad L)  so
# smoothing stops at strong edges, then detects scale-normalized Hessian-
# determinant extrema across the evolution ladder.  The diffusion is
# integrated with Fast Explicit Diffusion (FED) cycles — batches of
# explicit steps with the Chebyshev tau ladder
# tau_j = tau_max / (2 cos^2(pi (2j+1) / (4n+2))), which reach evolution
# time tau_max n(n+1)/3 per cycle while remaining stable — pure
# shifted-slice elementwise work, no solvers.
# ---------------------------------------------------------------------------

# Evolution-time ladder from the SIFT-style sigma ladder: t = sigma^2 / 2.
_KAZE_SIGMAS = (1.6, 2.26, 3.2, 4.53, 6.4)
_KAZE_SCALE = 4.0e4  # response -> shared detector-threshold range


def _fed_tau_ladder(n: int, tau_max: float = 0.25) -> np.ndarray:
    j = np.arange(n, dtype=np.float64)
    return (tau_max / (2.0 * np.cos(np.pi * (2 * j + 1) / (4 * n + 2)) ** 2)
            ).astype(np.float32)


def _fed_steps_for_time(T: float, tau_max: float = 0.25) -> int:
    """Smallest n with cycle time tau_max * n(n+1)/3 >= T."""
    n = 1
    while tau_max * n * (n + 1) / 3.0 < T:
        n += 1
    return n


def _grad_xy(L: jnp.ndarray):
    gx = 0.5 * (jnp.roll(L, -1, axis=1) - jnp.roll(L, 1, axis=1))
    gy = 0.5 * (jnp.roll(L, -1, axis=0) - jnp.roll(L, 1, axis=0))
    gx = gx.at[:, 0].set(0.0).at[:, -1].set(0.0)
    gy = gy.at[0, :].set(0.0).at[-1, :].set(0.0)
    return gx, gy


def _diffusion_substep(L: jnp.ndarray, g: jnp.ndarray, tau: float):
    """One explicit step of div(g grad L) with harmonic-free face
    conductivities (arithmetic mean, as KAZE) and zero-flux borders."""
    H, W = L.shape

    def flux(axis, direction):
        Ln = jnp.roll(L, -direction, axis=axis)
        gn = jnp.roll(g, -direction, axis=axis)
        f = 0.5 * (g + gn) * (Ln - L)
        # Zero-flux (Neumann) border: kill the wrapped faces.
        if axis == 0:
            f = f.at[-1 if direction == 1 else 0, :].set(0.0)
        else:
            f = f.at[:, -1 if direction == 1 else 0].set(0.0)
        return f

    div = (flux(1, 1) + flux(1, -1) + flux(0, 1) + flux(0, -1))
    return L + tau * div


def _kaze_contrast_k(L: jnp.ndarray, percentile: float = 0.7) -> jnp.ndarray:
    """KAZE contrast factor: the given percentile of nonzero gradient
    magnitudes (computed from a 64-bin histogram, as the reference
    implementation does)."""
    gx, gy = _grad_xy(gauss_blur(L, 1.0))
    mag = jnp.sqrt(gx * gx + gy * gy)
    mmax = jnp.maximum(jnp.max(mag), 1e-6)
    bins = jnp.clip((mag / mmax * 64.0).astype(jnp.int32), 0, 63)
    hist = jnp.zeros(64, jnp.int32).at[bins.reshape(-1)].add(
        (mag > 1e-6).reshape(-1).astype(jnp.int32)
    )
    hist = hist.at[0].set(0)
    total = jnp.maximum(jnp.sum(hist), 1)
    c = jnp.cumsum(hist)
    kbin = jnp.argmax(c >= (percentile * total).astype(jnp.int32))
    return jnp.maximum((kbin.astype(jnp.float32) + 0.5) / 64.0 * mmax, 1e-3)


def kaze_score_map(img: jnp.ndarray, threshold: jnp.ndarray) -> jnp.ndarray:
    """Nonlinear-diffusion scale-space Hessian extremum response.

    A pixel scores when it is a 26-neighborhood extremum of the
    scale-normalized Hessian determinant across the FED evolution ladder
    and clears the (host-controlled) threshold.  With conductivity forced
    to 1 the evolution reduces to Gaussian scale space (pinned by test
    against gauss_blur)."""
    x = img.astype(jnp.float32) * (1.0 / 255.0)
    L = gauss_blur(x, _KAZE_SIGMAS[0])
    k = _kaze_contrast_k(x)
    k2 = k * k
    levels = [L]
    t_prev = _KAZE_SIGMAS[0] ** 2 / 2.0
    for sigma in _KAZE_SIGMAS[1:]:
        t = sigma ** 2 / 2.0
        n = _fed_steps_for_time(t - t_prev)
        taus = _fed_tau_ladder(n)
        # Perona-Malik g2 conductivity, frozen per cycle (KAZE updates g
        # once per evolution step from the smoothed gradient).
        gx, gy = _grad_xy(gauss_blur(L, 1.0))
        g = 1.0 / (1.0 + (gx * gx + gy * gy) / k2)
        for tau in taus:
            L = _diffusion_substep(L, g, float(tau))
        levels.append(L)
        t_prev = t

    # Scale-adapted Hessian (KAZE computes its derivatives with
    # sigma-scaled Scharr operators, here central differences with step
    # d ~ sigma): nonlinear diffusion PRESERVES strong blobs across the
    # evolution, so fixed-step derivatives plus sigma^4 normalization
    # would grow monotonically with scale and the extremum test would
    # never fire.  Spatial 3x3 extremum per level, max across levels
    # (with these operators the across-scale profile of a persistent
    # structure is a plateau, so a 3D extremum degenerates to this).
    resp = []
    for sigma, Li in zip(_KAZE_SIGMAS, levels):
        d = max(1, int(round(sigma / 1.6)))

        def dstep(L, axis, dd=d):
            return (jnp.roll(L, -dd, axis) - jnp.roll(L, dd, axis)) * (
                0.5 / dd
            )

        Lx = dstep(Li, 1)
        Ly = dstep(Li, 0)
        Lxx = dstep(Lx, 1)
        Lxy = dstep(Lx, 0)
        Lyy = dstep(Ly, 0)
        det = Lxx * Lyy - Lxy * Lxy
        resp.append((sigma ** 2) ** 2 * det)
    D = jnp.stack(resp)  # (S, H, W)
    maxn = jax.lax.reduce_window(
        D, -jnp.inf, jax.lax.max, (1, 3, 3), (1, 1, 1), "SAME"
    )
    is_ext = (D >= maxn) & (D > 0)
    score = jnp.where(is_ext, D * _KAZE_SCALE, 0.0)
    score = jnp.max(score[1:-1], axis=0)  # interior evolution levels
    return jnp.where(score > threshold, score, 0.0)


# Detector registry (the reference's pluggable Detector hierarchy,
# base_framepoint_generator.h:10-107, selected by string detector_type).
# AGAST maps onto the same 16-pixel segment-test family as FAST (the
# reference wraps cv::AgastFeatureDetector; the adaptive tree it uses is an
# evaluation-order optimization of the identical corner criterion).
# SIFT/KAZE-class float detectors map onto DOG (io/config.py aliases).
def score_map(img, threshold, detector: str) -> jnp.ndarray:
    d = detector.upper()
    if d in ("FAST", "FAST9", "AGAST"):
        return fast_score_map(img, threshold, arc_len=9)
    if d == "FAST12":
        return fast_score_map(img, threshold, arc_len=12)
    if d == "HARRIS":
        return harris_score_map(img, threshold)
    if d in ("GFTT", "SHI_TOMASI"):
        return gftt_score_map(img, threshold)
    if d == "DOG":
        return dog_score_map(img, threshold)
    if d in ("KAZE", "AKAZE"):
        return kaze_score_map(img, threshold)
    raise ValueError(
        f"unknown detector '{detector}' "
        "(FAST|FAST12|AGAST|HARRIS|GFTT|DOG|KAZE|AKAZE)"
    )


def nms3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-maximum suppression."""
    neigh = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= neigh, score, 0.0)


def _detect_level(img, threshold, bin_size, capacity, border, detector):
    """Single-level pipeline: score -> NMS -> per-bin argmax -> top-K.

    Returns (uv (K,2) level-local pixel coords, score (K,), valid (K,)).
    """
    score = nms3(score_map(img, threshold, detector))
    return keypoints_from_score(score, bin_size, capacity, border)


def keypoints_from_score(score, bin_size, capacity, border):
    """Binning tail of the detection pipeline: border mask -> per-bin
    argmax -> top-K over an ALREADY-NMS'd score map."""
    H, W = score.shape

    # Mask out the border (descriptor patch margin).
    rows = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    inside = (
        (rows >= border) & (rows < H - border) & (cols >= border) & (cols < W - border)
    )
    score = jnp.where(inside, score, 0.0)

    # Per-bin argmax: crop to a multiple of bin_size, reshape to cells.
    Hc = (H // bin_size) * bin_size
    Wc = (W // bin_size) * bin_size
    sc = score[:Hc, :Wc].reshape(H // bin_size, bin_size, W // bin_size, bin_size)
    sc = sc.transpose(0, 2, 1, 3).reshape(-1, bin_size * bin_size)  # (cells, b*b)
    cell_best = jnp.argmax(sc, axis=1)
    cell_score = jnp.take_along_axis(sc, cell_best[:, None], axis=1)[:, 0]

    n_cells = sc.shape[0]
    k = min(capacity, n_cells)
    top_score, top_cell = jax.lax.top_k(cell_score, k)

    cells_w = W // bin_size
    cell_r = top_cell // cells_w
    cell_c = top_cell % cells_w
    in_r = jnp.take(cell_best, top_cell) // bin_size
    in_c = jnp.take(cell_best, top_cell) % bin_size
    v = cell_r * bin_size + in_r
    u = cell_c * bin_size + in_c

    uv = jnp.stack([u, v], axis=1).astype(jnp.float32)
    valid = top_score > 0.0
    if k < capacity:
        pad = capacity - k
        uv = jnp.concatenate([uv, jnp.zeros((pad, 2), jnp.float32)])
        top_score = jnp.concatenate([top_score, jnp.zeros(pad, jnp.float32)])
        valid = jnp.concatenate([valid, jnp.zeros(pad, bool)])
    return uv, top_score, valid


def downsample2(img: jnp.ndarray) -> jnp.ndarray:
    """2x2 average pooling (one pyramid octave down)."""
    H2 = (img.shape[0] // 2) * 2
    W2 = (img.shape[1] // 2) * 2
    c = img[:H2, :W2]
    return 0.25 * (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2])


def octave_capacities(capacity: int, octaves: int) -> list[int]:
    """Static per-octave keypoint budget: halving shares, remainder to
    level 0 (cv::ORB distributes per-level feature counts the same way,
    base_framepoint_generator.cpp:52-70)."""
    if octaves == 1:
        return [capacity]
    shares = [capacity >> (o + 1) for o in range(1, octaves)]
    return [capacity - sum(shares)] + shares


@partial(jax.jit, static_argnames=("bin_size", "capacity", "border",
                                   "detector", "octaves"))
def detect_keypoints(
    img: jnp.ndarray,
    threshold: jnp.ndarray,
    bin_size: int = 16,
    capacity: int = 1024,
    border: int = 20,
    detector: str = "FAST",
    octaves: int = 1,
) -> Keypoints:
    """Multi-octave detection over a 2x image pyramid (cv::ORB-class
    multi-scale behaviour, base_framepoint_generator.cpp:28-136): each
    octave runs the full single-level pipeline on a 2x-downsampled image
    with a static share of the capacity; keypoint coordinates map back to
    level 0.  octaves=1 is the original single-scale path.
    """
    uvs, scores, valids, octs = [], [], [], []
    level = img
    for o, cap_o in enumerate(octave_capacities(capacity, octaves)):
        if o > 0:
            level = downsample2(level)
        uv, sc, va = _detect_level(level, threshold, bin_size, cap_o, border,
                                   detector)
        scale = float(1 << o)
        # Level-o pixel (r, c) covers level-0 pixels [r*s, r*s + s); its
        # center in level-0 coordinates is r*s + (s-1)/2.
        uvs.append(uv * scale + (scale - 1.0) / 2.0)
        scores.append(sc)
        valids.append(va)
        octs.append(jnp.full(cap_o, o, jnp.int32))
    return Keypoints(
        uv=jnp.concatenate(uvs),
        score=jnp.concatenate(scores),
        valid=jnp.concatenate(valids),
        octave=jnp.concatenate(octs),
    )


class ThresholdController:
    """Host-side delta-proportional detector threshold controller.

    Reference: detectKeypoints' dynamic threshold targeting #bins keypoints
    per region, clamped per-step (base_framepoint_generator.cpp:355-459).
    Here a single controller for the whole image (regularization is done by
    binning, so only the global count needs controlling).
    """

    def __init__(
        self,
        initial: float = 20.0,
        target_count: int = 700,
        max_change: float = 10.0,
        minimum: float = 5.0,
        maximum: float = 100.0,
    ):
        self.threshold = float(initial)
        self.target = int(target_count)
        self.max_change = float(max_change)
        self.min = float(minimum)
        self.max = float(maximum)

    def update(self, detected_count: int) -> float:
        err = (detected_count - self.target) / max(self.target, 1)
        delta = float(np.clip(err * self.max_change, -self.max_change, self.max_change))
        self.threshold = float(np.clip(self.threshold + delta, self.min, self.max))
        return self.threshold
