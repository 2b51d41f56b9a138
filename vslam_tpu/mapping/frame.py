"""Per-frame state and the fused front-end / tracking device programs.

FrameState is the array-program replacement for the reference's
Frame + FramePoint object graph (src/types/frame.h:92-106,
src/types/frame_point.h:18-203): a fixed-capacity SoA pytree with a valid
mask; the pointer-based temporal track (`previous`/`next`) becomes the
integer columns `track_len` and `landmark_slot` carried forward by the
tracker.

Two fused jit programs do all per-frame device math:

  process_stereo_pair  detect L/R -> describe L/R -> epipolar match ->
                       triangulate -> compact (the reference's
                       `initialize` + `compute`,
                       stereo_framepoint_generator.cpp:73-133,135-426)
  track_and_align      project prior points -> windowed Hamming match ->
                       build 4D residuals -> robust GN pose solve (the
                       reference's `track` + StereoUVAligner::converge,
                       stereo_framepoint_generator.cpp:464-681 +
                       stereouv_aligner.cpp:210-255)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from vslam_tpu.frontend import brief, detect, matching, orb


def _describe(img, uv, descriptor: str):
    """Descriptor dispatch: dense BRIEF (reference default, gather-free),
    rotated-bank BRIEF (orientation-aware), or rotation-aware gather ORB."""
    if descriptor == "ORB256":
        return orb.describe(img, uv)
    if descriptor == "BRIEF256R":
        return brief.describe_dense_rotated(img, uv)
    return brief.describe_dense(img, uv)
from vslam_tpu.ops import camera as cam_ops
from vslam_tpu.ops import lie
from vslam_tpu.solve import aligners, gn


class FrameState(NamedTuple):
    """Stereo framepoints of one frame (capacity K, masked, compacted)."""

    uv4: jnp.ndarray  # (K, 4) [uL, vL, uR, vR]
    desc: jnp.ndarray  # (K, 8) uint32 left descriptors
    p_cam: jnp.ndarray  # (K, 3) points in this camera's frame
    valid: jnp.ndarray  # (K,) bool
    track_len: jnp.ndarray  # (K,) int32, 1 for fresh stereo points
    landmark_slot: jnp.ndarray  # (K,) int32 into the landmark table, -1 none
    # False = TEMPORARY point (reference's unreliable framepoints,
    # frame.h:92-106 createFramepoint(temporary)): disparity below the
    # stereo minimum, so p_cam carries a capped-depth guess; the point is
    # tracked in 2D and promoted once midpoint triangulation from motion
    # succeeds (pose_tracker_3d.cpp:524-545).
    reliable: jnp.ndarray  # (K,) bool

    @property
    def capacity(self):
        return self.uv4.shape[0]


def empty_frame(capacity: int) -> FrameState:
    return FrameState(
        uv4=jnp.zeros((capacity, 4), jnp.float32),
        desc=jnp.zeros((capacity, 8), jnp.uint32),
        p_cam=jnp.zeros((capacity, 3), jnp.float32),
        valid=jnp.zeros(capacity, bool),
        track_len=jnp.zeros(capacity, jnp.int32),
        landmark_slot=jnp.full(capacity, -1, jnp.int32),
        reliable=jnp.zeros(capacity, bool),
    )


def stable_partition_perm(valid: jnp.ndarray) -> jnp.ndarray:
    """Permutation putting valid rows first (stable), via cumsum + scatter.

    Equivalent to argsort(~valid, stable=True) but an O(K) cumsum and
    scatter instead of a sort."""
    k = valid.shape[0]
    rank_v = jnp.cumsum(valid.astype(jnp.int32)) - 1
    n_valid = jnp.sum(valid.astype(jnp.int32))
    rank_i = jnp.cumsum((~valid).astype(jnp.int32)) - 1
    dest = jnp.where(valid, rank_v, n_valid + rank_i)
    return jnp.zeros(k, jnp.int32).at[dest].set(
        jnp.arange(k, dtype=jnp.int32), unique_indices=True
    )


def _compact(order_key: jnp.ndarray, *arrays):
    """Reorder arrays so rows with order_key True come first (stable)."""
    perm = stable_partition_perm(order_key)
    return tuple(a[perm] for a in arrays)


def _pyramid_descriptors(img_l, img_r, kl, kr, capacity, octaves):
    """Per-octave dense-BRIEF description: each octave's keypoint slice
    (static ranges — detect_keypoints concatenates per octave) gathers
    from the planes of ITS pyramid level, so descriptors sample the scale
    the corner was detected at (cv::ORB per-level description,
    base_framepoint_generator.cpp:52-70).

    Returns (dl (K,8), dr (K,8), planes0 (2,8,H,W) level-0 planes)."""
    planes0 = brief.dense_planes_pair(img_l, img_r)
    caps = detect.octave_capacities(capacity, octaves)
    dl_parts, dr_parts = [], []
    lvl_l, lvl_r = img_l, img_r
    start = 0
    for o, cap_o in enumerate(caps):
        if o == 0:
            pl_l, pl_r = planes0[0], planes0[1]
        else:
            lvl_l = detect.downsample2(lvl_l)
            lvl_r = detect.downsample2(lvl_r)
            pl_l = brief.dense_planes(lvl_l)
            pl_r = brief.dense_planes(lvl_r)
        s = float(1 << o)
        sl = slice(start, start + cap_o)
        uv_l_o = (kl.uv[sl] - (s - 1.0) / 2.0) / s
        uv_r_o = (kr.uv[sl] - (s - 1.0) / 2.0) / s
        dl_parts.append(brief.gather_descriptors(pl_l, lvl_l.shape, uv_l_o))
        dr_parts.append(brief.gather_descriptors(pl_r, lvl_r.shape, uv_r_o))
        start += cap_o
    return jnp.concatenate(dl_parts), jnp.concatenate(dr_parts), planes0


def stereo_frontend_core(
    cam: cam_ops.CameraParams,
    img_l: jnp.ndarray,
    img_r: jnp.ndarray,
    threshold: jnp.ndarray,
    max_hamming_stereo: jnp.ndarray,
    epipolar_tol: jnp.ndarray,
    min_disparity: jnp.ndarray,
    max_disparity: jnp.ndarray,
    capacity: int = 1024,
    bin_size: int = 16,
    border: int = 20,
    descriptor: str = "BRIEF256",
    detector: str = "FAST",
    want_planes: bool = False,
    octaves: int = 1,
):
    """Stereo front-end body (traced inside process_stereo_pair and the
    fused frame step).  With want_planes=True (BRIEF path) also returns the
    (2, 8, H, W) dense descriptor planes for downstream re-description at
    arbitrary coordinates (landmark recovery).  octaves > 1 detects and
    describes over a 2x image pyramid (scale robustness)."""
    kl = detect.detect_keypoints(img_l, threshold, bin_size, capacity, border,
                                 detector, octaves=octaves)
    kr = detect.detect_keypoints(img_r, threshold, bin_size, capacity, border,
                                 detector, octaves=octaves)
    planes = None
    if descriptor == "ORB256":
        dl = _describe(img_l, kl.uv, descriptor)
        dr = _describe(img_r, kr.uv, descriptor)
    elif descriptor == "BRIEF256R":
        # Orientation-aware rotated-bank descriptors; landmark recovery
        # re-describes from UNROTATED planes (its descriptor gate rejects
        # candidates under heavy in-plane rotation — graceful, and exact
        # in the upright-dominated case).
        dl = brief.describe_dense_rotated(img_l, kl.uv)
        dr = brief.describe_dense_rotated(img_r, kr.uv)
        if want_planes:
            planes = brief.dense_planes_pair(img_l, img_r)
    elif octaves > 1:
        dl, dr, planes = _pyramid_descriptors(img_l, img_r, kl, kr, capacity,
                                              octaves)
    else:
        planes = brief.dense_planes_pair(img_l, img_r)
        dl = brief.gather_descriptors(planes[0], img_l.shape, kl.uv)
        dr = brief.gather_descriptors(planes[1], img_r.shape, kr.uv)

    # Epipolar match -> triangulation -> compaction -> FrameState.
    # Matches below min_disparity are KEPT as temporary points (reference
    # unreliable framepoints): disparity gate opens down to 0, reliability
    # records whether proper stereo triangulation was possible.
    m = matching.match_stereo(
        kl.uv, dl, kl.valid, kr.uv, dr, kr.valid,
        max_hamming_stereo, epipolar_tol, jnp.float32(0.0), max_disparity,
    )
    uv_l = kl.uv
    uv_r = kr.uv[m.right_idx]
    disp = uv_l[:, 0] - uv_r[:, 0]
    reliable = disp >= min_disparity
    # Capped-depth guess for temporary points (z at the stereo ceiling).
    p_cam, _ = cam_ops.triangulate_disparity(cam, uv_l, uv_r, 1.0)
    p_cam = jnp.where(
        reliable[:, None],
        p_cam,
        cam_ops.back_project(
            cam, uv_l, jnp.full_like(disp, cam.fx * cam.baseline_m)
            / jnp.maximum(min_disparity, 0.25)
        ),
    )
    valid = m.valid & kl.valid & (p_cam[:, 2] > 0)

    uv4 = jnp.concatenate([uv_l, uv_r], axis=1)
    uv4, desc, p_cam, valid, reliable = _compact(
        valid, uv4, dl, p_cam, valid, reliable
    )
    frame = FrameState(
        uv4=uv4,
        desc=desc,
        p_cam=p_cam,
        valid=valid,
        track_len=jnp.where(valid, 1, 0).astype(jnp.int32),
        landmark_slot=jnp.full(capacity, -1, jnp.int32),
        reliable=reliable & valid,
    )
    n_kp = jnp.sum(kl.valid).astype(jnp.int32)
    n_fp = jnp.sum(valid & reliable).astype(jnp.int32)
    if want_planes:
        return frame, n_kp, n_fp, planes
    return frame, n_kp, n_fp


@partial(jax.jit,
         static_argnames=("capacity", "bin_size", "border", "descriptor",
                          "detector", "octaves"))
def process_stereo_pair(
    cam: cam_ops.CameraParams,
    img_l: jnp.ndarray,
    img_r: jnp.ndarray,
    threshold: jnp.ndarray,
    max_hamming_stereo: jnp.ndarray,
    epipolar_tol: jnp.ndarray,
    min_disparity: jnp.ndarray,
    max_disparity: jnp.ndarray,
    capacity: int = 1024,
    bin_size: int = 16,
    border: int = 20,
    descriptor: str = "BRIEF256",
    detector: str = "FAST",
    octaves: int = 1,
):
    """Full stereo front-end for one image pair, one XLA program.

    Returns (FrameState, n_keypoints_left (int32), n_framepoints (int32)).
    """
    return stereo_frontend_core(
        cam, img_l, img_r, threshold, max_hamming_stereo, epipolar_tol,
        min_disparity, max_disparity, capacity=capacity, bin_size=bin_size,
        border=border, descriptor=descriptor, detector=detector,
        want_planes=False, octaves=octaves,
    )


@partial(jax.jit,
         static_argnames=("capacity", "bin_size", "border", "descriptor",
                          "detector", "want_planes", "octaves"))
def process_depth_frame(
    cam: cam_ops.CameraParams,
    img: jnp.ndarray,
    depth_m: jnp.ndarray,  # registered to the intensity camera
    threshold: jnp.ndarray,
    min_depth: jnp.ndarray,
    max_depth: jnp.ndarray,
    capacity: int = 1024,
    bin_size: int = 16,
    border: int = 20,
    descriptor: str = "BRIEF256",
    detector: str = "FAST",
    want_planes: bool = False,
    octaves: int = 1,
):
    """RGB-D front-end: detect -> describe -> depth gather -> back-project.

    FrameState.uv4 carries [u, v, depth_m, 0] in depth mode (the 4th slot
    unused).  Reference: DepthFramePointGenerator::compute
    (depth_framepoint_generator.cpp:46-164).  With want_planes=True (BRIEF
    path) also returns the (8, H, W) dense descriptor planes for landmark
    recovery re-description.
    """
    from vslam_tpu.frontend import depth as depth_mod

    kp = detect.detect_keypoints(img, threshold, bin_size, capacity, border,
                                 detector, octaves=octaves)
    planes = None
    if descriptor == "ORB256":
        desc = _describe(img, kp.uv, descriptor)
    elif descriptor == "BRIEF256R":
        desc = _describe(img, kp.uv, descriptor)
        if want_planes:
            planes = brief.dense_planes(img)
    elif octaves > 1:
        caps = detect.octave_capacities(capacity, octaves)
        parts = []
        lvl = img
        start = 0
        for o, cap_o in enumerate(caps):
            if o == 0:
                pl = brief.dense_planes(img)
                planes = pl  # level-0 planes kept for recovery
            else:
                lvl = detect.downsample2(lvl)
                pl = brief.dense_planes(lvl)
            sc = float(1 << o)
            sl = slice(start, start + cap_o)
            parts.append(brief.gather_descriptors(
                pl, lvl.shape, (kp.uv[sl] - (sc - 1.0) / 2.0) / sc
            ))
            start += cap_o
        desc = jnp.concatenate(parts)
        if not want_planes:
            planes = None
    elif not want_planes:
        desc = _describe(img, kp.uv, descriptor)
    else:
        planes = brief.dense_planes(img)  # (8, H, W)
        desc = brief.gather_descriptors(planes, img.shape, kp.uv)
    z = depth_mod.gather_depth(depth_m, kp.uv)
    valid = kp.valid & (z >= min_depth) & (z <= max_depth)
    p_cam = cam_ops.back_project(cam, kp.uv, z)

    uv4 = jnp.concatenate([kp.uv, z[:, None], jnp.zeros_like(z[:, None])], axis=1)
    uv4, desc, p_cam, valid = _compact(valid, uv4, desc, p_cam, valid)
    frame = FrameState(
        uv4=uv4,
        desc=desc,
        p_cam=p_cam,
        valid=valid,
        track_len=jnp.where(valid, 1, 0).astype(jnp.int32),
        landmark_slot=jnp.full(capacity, -1, jnp.int32),
        reliable=valid,  # depth sensor points carry measured range
    )
    n_kp = jnp.sum(kp.valid).astype(jnp.int32)
    n_fp = jnp.sum(valid).astype(jnp.int32)
    if want_planes:
        return frame, n_kp, n_fp, planes
    return frame, n_kp, n_fp


class TrackResult(NamedTuple):
    T_cur_prev: jnp.ndarray  # (4, 4) estimated camera motion
    prev_to_cur: jnp.ndarray  # (Kprev,) int32 index into cur frame, -1 unmatched
    n_matches: jnp.ndarray  # int32
    n_inliers: jnp.ndarray  # int32
    mean_chi2: jnp.ndarray  # f32
    converged: jnp.ndarray  # bool


@partial(jax.jit, static_argnames=("gn_config",))
def track_and_align(
    cam: cam_ops.CameraParams,
    prev: FrameState,
    cur: FrameState,
    T_guess: jnp.ndarray,  # (4, 4) prev-camera -> cur-camera
    radius_px: jnp.ndarray,
    max_hamming: jnp.ndarray,
    point_weights: jnp.ndarray,  # (Kprev,) landmark-informed weights
    gn_config: gn.GNConfig = gn.GNConfig(),
) -> TrackResult:
    """Track prev framepoints into cur and solve for the camera motion."""
    p_pred = lie.transform_point_cloud(T_guess, prev.p_cam)
    proj_uv, z_pred = cam_ops.project(cam, p_pred)
    predictable = prev.valid & (z_pred > 0.05)

    m = matching.match_projective(
        proj_uv, prev.desc, predictable,
        cur.uv4[:, :2], cur.desc, cur.valid,
        radius_px, max_hamming,
    )
    matched = m.valid & predictable

    # Temporary points carry only a capped-depth guess: they still inform
    # rotation (far points) but get a small weight so their wrong depth
    # cannot bias translation (reference zeroes translation rows for
    # unreliable points, uvd_aligner.cpp:55-61).
    weights = jnp.where(prev.reliable, point_weights, 0.2 * point_weights)
    data = aligners.StereoUVData(
        p_prev=prev.p_cam,
        meas=cur.uv4[m.cur_idx],
        weight=weights,
    )
    # Analytic-Jacobian solver: identical semantics to the generic
    # stereo_uv_align (asserted in tests), with no autodiff in the loop.
    res = aligners.stereo_uv_align_fast(cam, data, matched, T_guess, gn_config)

    prev_to_cur = jnp.where(matched, m.cur_idx, -1).astype(jnp.int32)
    return TrackResult(
        T_cur_prev=res.x,
        prev_to_cur=prev_to_cur,
        n_matches=jnp.sum(matched).astype(jnp.int32),
        n_inliers=res.num_inliers,
        mean_chi2=res.chi2,
        converged=res.converged,
    )


@partial(jax.jit, static_argnames=("gn_config",))
def track_and_align_uvd(
    cam: cam_ops.CameraParams,
    prev: FrameState,
    cur: FrameState,
    T_guess: jnp.ndarray,
    radius_px: jnp.ndarray,
    max_hamming: jnp.ndarray,
    point_weights: jnp.ndarray,
    gn_config: gn.GNConfig = gn.GNConfig(),
) -> TrackResult:
    """RGB-D variant of track_and_align: 3D [u, v, depth] residuals via the
    UVD aligner (reference UVDAligner, uvd_aligner.cpp)."""
    p_pred = lie.transform_point_cloud(T_guess, prev.p_cam)
    proj_uv, z_pred = cam_ops.project(cam, p_pred)
    predictable = prev.valid & (z_pred > 0.05)

    m = matching.match_projective(
        proj_uv, prev.desc, predictable,
        cur.uv4[:, :2], cur.desc, cur.valid,
        radius_px, max_hamming,
    )
    matched = m.valid & predictable

    meas = cur.uv4[m.cur_idx][:, :3]  # [u, v, depth]
    data = aligners.UVDData(
        p_prev=prev.p_cam,
        meas=meas,
        weight=point_weights,
        depth_reliable=meas[:, 2] > 0.01,
    )
    res = aligners.uvd_align(cam, data, matched, T_guess, gn_config)

    prev_to_cur = jnp.where(matched, m.cur_idx, -1).astype(jnp.int32)
    return TrackResult(
        T_cur_prev=res.x,
        prev_to_cur=prev_to_cur,
        n_matches=jnp.sum(matched).astype(jnp.int32),
        n_inliers=res.num_inliers,
        mean_chi2=res.chi2,
        converged=res.converged,
    )


def recover_lost_landmarks(
    cam: cam_ops.CameraParams,
    prev: FrameState,
    cur: FrameState,
    motion: jnp.ndarray,  # (4, 4) T_cur_prev from the pose solve
    prev_to_cur: jnp.ndarray,  # (K,) match indices, -1 = lost
    planes,  # (2, 8, H, W) dense BRIEF planes or None (ORB mode)
    img_l: jnp.ndarray,
    img_r: jnp.ndarray,
    desc_gate: jnp.ndarray,  # scalar Hamming gate
    min_disparity: jnp.ndarray,
    max_disparity: jnp.ndarray,
    border: int = 20,
    descriptor: str = "BRIEF256",
    enabled: jnp.ndarray = True,  # gate on registration success
):
    """Landmark recovery (reference recoverPoints,
    stereo_framepoint_generator.cpp:683-869): landmark-backed points of the
    previous frame that found no detected match are re-acquired by
    projecting them with the SOLVED pose and re-extracting descriptors at
    the projected coordinates in both images — a pure gather against the
    dense descriptor planes (no re-detection).  Gated on descriptor
    distance in both views, field-of-view and the disparity range, then
    re-triangulated and appended to the free rows of the current frame.

    Returns (cur', n_recovered int32).
    """
    from vslam_tpu.ops import hamming

    lost = prev.valid & (prev.landmark_slot >= 0) & (prev_to_cur < 0)
    p_pred = lie.transform_point_cloud(motion, prev.p_cam)
    uv_l, uv_r, z = cam_ops.project_stereo(cam, p_pred)
    vis = cam_ops.in_field_of_view(cam, uv_l, z, border) & cam_ops.in_field_of_view(
        cam, uv_r, z, border
    )
    if descriptor == "ORB256":
        dl = orb.describe(img_l, uv_l)
        dr = orb.describe(img_r, uv_r)
    else:
        dl = brief.gather_descriptors(planes[0], img_l.shape, uv_l)
        dr = brief.gather_descriptors(planes[1], img_r.shape, uv_r)
    d_l = hamming.hamming_pairwise(dl, prev.desc)
    d_r = hamming.hamming_pairwise(dr, prev.desc)
    gate = desc_gate.astype(d_l.dtype)
    p_cam_rec, tri_ok = cam_ops.triangulate_disparity(cam, uv_l, uv_r, 1.0)
    disp = uv_l[:, 0] - uv_r[:, 0]
    ok = (
        lost
        & vis
        & (d_l <= gate)
        & (d_r <= gate)
        & tri_ok
        & (disp >= min_disparity)
        & (disp <= max_disparity)
        & enabled
    )

    # Append into the free rows after the compacted valid block.
    n_valid = jnp.sum(cur.valid).astype(jnp.int32)
    order = jnp.cumsum(ok.astype(jnp.int32)) - 1
    dest = n_valid + order
    use = ok & (dest < cur.capacity)
    tgt = jnp.where(use, dest, 0)

    def put(arr, val, zero):
        u = use.reshape((-1,) + (1,) * (arr.ndim - 1))
        return arr.at[tgt].add(jnp.where(u, val - arr[tgt], zero))

    uv4_rec = jnp.concatenate([uv_l, uv_r], axis=1)
    cur = cur._replace(
        uv4=put(cur.uv4, uv4_rec, 0.0),
        desc=put(cur.desc, dl, jnp.uint32(0)),
        p_cam=put(cur.p_cam, p_cam_rec, 0.0),
        valid=cur.valid.at[tgt].max(use),
        track_len=put(cur.track_len, prev.track_len + 1, 0),
        landmark_slot=put(cur.landmark_slot, prev.landmark_slot, 0),
        reliable=cur.reliable.at[tgt].max(use),
    )
    return cur, jnp.sum(use).astype(jnp.int32)


def recover_lost_landmarks_depth(
    cam: cam_ops.CameraParams,
    prev: FrameState,
    cur: FrameState,
    motion: jnp.ndarray,  # (4, 4) T_cur_prev from the pose solve
    prev_to_cur: jnp.ndarray,  # (K,) match indices, -1 = lost
    planes,  # (8, H, W) dense BRIEF planes of the intensity image
    img: jnp.ndarray,
    depth_m: jnp.ndarray,  # registered depth (meters)
    desc_gate: jnp.ndarray,
    min_depth: jnp.ndarray,
    max_depth: jnp.ndarray,
    border: int = 20,
    descriptor: str = "BRIEF256",
    enabled: jnp.ndarray = True,
    max_depth_error_ratio: float = 0.2,
):
    """RGB-D landmark recovery (reference DepthFramePointGenerator::
    recoverPoints, depth_framepoint_generator.cpp:300-408): lost
    landmark-backed points are re-acquired at their solved-pose
    projections — descriptor re-extracted from the dense planes, depth
    looked up in the registered map, gated on descriptor distance, the
    depth range and predicted-vs-measured depth consistency.

    Returns (cur', n_recovered int32).
    """
    from vslam_tpu.frontend import depth as depth_mod
    from vslam_tpu.ops import hamming

    lost = prev.valid & (prev.landmark_slot >= 0) & (prev_to_cur < 0)
    p_pred = lie.transform_point_cloud(motion, prev.p_cam)
    uv, z_pred = cam_ops.project(cam, p_pred)
    vis = cam_ops.in_field_of_view(cam, uv, z_pred, border)
    if descriptor == "ORB256":
        d = orb.describe(img, uv)
    else:
        d = brief.gather_descriptors(planes, img.shape, uv)
    dist = hamming.hamming_pairwise(d, prev.desc)
    z_meas = depth_mod.gather_depth(depth_m, uv)
    depth_ok = (
        (z_meas >= min_depth)
        & (z_meas <= max_depth)
        & (jnp.abs(z_meas - z_pred) <= max_depth_error_ratio * jnp.maximum(z_meas, 0.5))
    )
    ok = lost & vis & (dist <= desc_gate.astype(dist.dtype)) & depth_ok & enabled
    p_cam_rec = cam_ops.back_project(cam, uv, z_meas)

    # Append into the free rows after the compacted valid block (same
    # scatter scheme as the stereo recovery above).
    n_valid = jnp.sum(cur.valid).astype(jnp.int32)
    order = jnp.cumsum(ok.astype(jnp.int32)) - 1
    dest = n_valid + order
    use = ok & (dest < cur.capacity)
    tgt = jnp.where(use, dest, 0)

    def put(arr, val, zero):
        u = use.reshape((-1,) + (1,) * (arr.ndim - 1))
        return arr.at[tgt].add(jnp.where(u, val - arr[tgt], zero))

    uv4_rec = jnp.concatenate(
        [uv, z_meas[:, None], jnp.zeros_like(z_meas[:, None])], axis=1
    )
    cur = cur._replace(
        uv4=put(cur.uv4, uv4_rec, 0.0),
        desc=put(cur.desc, d, jnp.uint32(0)),
        p_cam=put(cur.p_cam, p_cam_rec, 0.0),
        valid=cur.valid.at[tgt].max(use),
        track_len=put(cur.track_len, prev.track_len + 1, 0),
        landmark_slot=put(cur.landmark_slot, prev.landmark_slot, 0),
        reliable=cur.reliable.at[tgt].max(use),
    )
    return cur, jnp.sum(use).astype(jnp.int32)


def promote_temporary_points(
    cam: cam_ops.CameraParams,
    prev: FrameState,
    cur: FrameState,
    motion: jnp.ndarray,  # (4, 4) T_cur_prev from the pose solve
    prev_to_cur: jnp.ndarray,
    enabled: jnp.ndarray = True,
    max_depth: float = 500.0,
):
    """Deferred midpoint triangulation of temporary points (reference
    pose_tracker_3d.cpp:524-545 + getPointInCamera): a tracked temporary
    point whose two views now subtend enough parallax gets a proper 3D
    position from two-view midpoint triangulation against the solved
    motion, and becomes reliable.

    Returns (cur', n_promoted int32).
    """
    matched = (prev_to_cur >= 0) & prev.valid & ~prev.reliable & enabled
    j = jnp.where(prev_to_cur >= 0, prev_to_cur, 0)
    uv_cur = cur.uv4[j, :2]
    mid, ok3 = cam_ops.triangulate_midpoint(
        cam, uv_cur, prev.uv4[:, :2], motion, max_depth=max_depth
    )
    promote = matched & ~cur.reliable[j] & ok3
    tgt = jnp.where(promote, j, 0)
    p_cam = cur.p_cam.at[tgt].add(
        jnp.where(promote[:, None], mid - cur.p_cam[tgt], 0.0)
    )
    reliable = cur.reliable.at[tgt].max(promote)
    return cur._replace(p_cam=p_cam, reliable=reliable), jnp.sum(promote).astype(
        jnp.int32
    )


@jax.jit
def propagate_tracks(
    prev: FrameState, cur: FrameState, prev_to_cur: jnp.ndarray
) -> FrameState:
    """Carry track length and landmark links from prev into matched cur
    slots (the reference's FramePoint::setPrevious chain,
    frame_point.cpp:43-55, as a scatter)."""
    matched = prev_to_cur >= 0
    tgt = jnp.where(matched, prev_to_cur, 0)
    new_len = cur.track_len.at[tgt].add(jnp.where(matched, prev.track_len, 0))
    new_lm = cur.landmark_slot.at[tgt].max(
        jnp.where(matched, prev.landmark_slot, -1)
    )
    return cur._replace(track_len=new_len, landmark_slot=new_lm)
