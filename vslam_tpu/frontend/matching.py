"""Stereo epipolar and projective descriptor matching kernels.

Two instantiations of the masked-Hamming-argmin primitive (ops/hamming.py,
int8-matmul path: at frame capacity the popcount path materializes a
K^2 x 8-word XOR intermediate — ~33 MB of device-memory traffic — while
the bit matmul is one integer GEMM),
replacing the reference's serial matchers:

  match_stereo      the row-sorted exhaustive epipolar sweep
                    (stereo_framepoint_generator.cpp:278-426) becomes a full
                    LxR distance matrix masked by the epipolar band and the
                    disparity range, resolved one-to-one by mutual-best
                    cross-check (the parallel semantics of the reference's
                    greedy consume-on-match scan, SURVEY.md §7.3).
  match_projective  the rectangular-ROI best-Hamming search around projected
                    coordinates (intensity_feature_matcher.cpp:81-148),
                    as a distance matrix masked by a Chebyshev pixel window.

Both take fixed-capacity masked keypoint sets and dynamic scalar gates
(search radius, descriptor threshold) so the host's adaptive controllers
(pose_tracker_3d.cpp:251-288) never trigger recompiles.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vslam_tpu.ops import hamming


class StereoMatches(NamedTuple):
    right_idx: jnp.ndarray  # (L,) int32 index into right keypoints
    distance: jnp.ndarray  # (L,) int32 Hamming distance
    valid: jnp.ndarray  # (L,) bool


class ProjectiveMatches(NamedTuple):
    cur_idx: jnp.ndarray  # (P,) int32 index into current keypoints
    distance: jnp.ndarray  # (P,) int32
    valid: jnp.ndarray  # (P,) bool


@jax.jit
def match_stereo(
    uv_l: jnp.ndarray,  # (L, 2)
    desc_l: jnp.ndarray,  # (L, 8) uint32
    mask_l: jnp.ndarray,  # (L,)
    uv_r: jnp.ndarray,  # (R, 2)
    desc_r: jnp.ndarray,  # (R, 8) uint32
    mask_r: jnp.ndarray,  # (R,)
    max_hamming: jnp.ndarray,  # scalar int
    epipolar_tol: jnp.ndarray,  # scalar f32: |v_l - v_r| tolerance (pixels)
    min_disparity: jnp.ndarray,  # scalar f32
    max_disparity: jnp.ndarray,  # scalar f32
) -> StereoMatches:
    """One-to-one stereo correspondence under epipolar + disparity gates."""
    dist = hamming.hamming_matrix_mxu(desc_l, desc_r)  # (L, R)
    dv = jnp.abs(uv_l[:, None, 1] - uv_r[None, :, 1])
    disp = uv_l[:, None, 0] - uv_r[None, :, 0]
    mask = (
        mask_l[:, None]
        & mask_r[None, :]
        & (dv <= epipolar_tol)
        & (disp >= min_disparity)
        & (disp <= max_disparity)
    )
    idx, valid, best = hamming.mutual_best_match(dist, mask, max_hamming)
    return StereoMatches(right_idx=idx, distance=best, valid=valid)


@jax.jit
def match_projective(
    proj_uv: jnp.ndarray,  # (P, 2) predicted projections of prior points
    desc_prev: jnp.ndarray,  # (P, 8)
    mask_prev: jnp.ndarray,  # (P,)
    uv_cur: jnp.ndarray,  # (C, 2) detected keypoints in current frame
    desc_cur: jnp.ndarray,  # (C, 8)
    mask_cur: jnp.ndarray,  # (C,)
    radius_px: jnp.ndarray,  # scalar f32 — the adaptive tracking window
    max_hamming: jnp.ndarray,  # scalar int — the adaptive descriptor gate
) -> ProjectiveMatches:
    """Track prior points into the current frame by windowed Hamming match."""
    dist = hamming.hamming_matrix_mxu(desc_prev, desc_cur)  # (P, C)
    du = jnp.abs(proj_uv[:, None, 0] - uv_cur[None, :, 0])
    dv = jnp.abs(proj_uv[:, None, 1] - uv_cur[None, :, 1])
    mask = (
        mask_prev[:, None]
        & mask_cur[None, :]
        & (du <= radius_px)
        & (dv <= radius_px)
    )
    idx, valid, best = hamming.mutual_best_match(dist, mask, max_hamming)
    return ProjectiveMatches(cur_idx=idx, distance=best, valid=valid)
