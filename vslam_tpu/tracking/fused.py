"""The fused per-frame device program: one dispatch per frame.

The modular per-stage path (detect -> match -> track -> spawn -> update
as separate jit calls with host decisions between them) pays ~10
host<->device round trips per frame, each with its dispatch and transfer
latency.  This module fuses the
ENTIRE per-frame pipeline (reference PoseTracker3D::compute,
pose_tracker_3d.cpp:32-200, including the _registerRecursive retry ladder
:300-419, the adaptive window controller :251-288, landmark creation
:475-549 and the detector threshold controller
base_framepoint_generator.cpp:355-459) into ONE XLA program over a
device-resident TrackerState:

  * retries   -> nested lax.cond re-runs of the matcher/solver with wider
                 gates (both branches compiled once);
  * landmark allocation -> device prefix-sum slot assignment against an
                 in-state next_slot counter (host free-list bookkeeping is
                 reconciled only at merge events);
  * adaptive scalars (search radius, descriptor gate, FAST threshold) ->
                 carried in-state and updated in-graph.

Per frame the host does: upload 2 images, one frame_step dispatch, read
back a (4,4) pose + a handful of stats scalars.

The modular kernels in mapping/frame.py remain the unit-tested reference
implementations; this program calls the same functions (nested jit is
inlined during tracing), so the two paths cannot diverge.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vslam_tpu.mapping import frame as frame_mod
from vslam_tpu.mapping import landmarks as lm_mod
from vslam_tpu.ops import camera as cam_ops
from vslam_tpu.ops import lie
from vslam_tpu.solve import gn


class TrackerState(NamedTuple):
    """Complete device-resident tracker state."""

    prev: frame_mod.FrameState
    table: lm_mod.LandmarkTable
    T_world_cam: jnp.ndarray  # (4, 4)
    last_motion: jnp.ndarray  # (4, 4) T_cur_prev
    radius_px: jnp.ndarray  # f32 scalar
    desc_gate: jnp.ndarray  # f32 scalar
    threshold: jnp.ndarray  # f32 scalar (FAST)
    next_slot: jnp.ndarray  # int32 scalar
    frame_idx: jnp.ndarray  # int32 scalar
    has_prev: jnp.ndarray  # bool scalar
    # Tracker status (reference Frame::Localizing|Tracking, frame.h:19):
    # True while the last registration failed (or at start/after resume) —
    # the next track attempt then matches BY APPEARANCE (projection-free
    # global Hamming match, pose_tracker_3d.cpp:87-92,227-239) instead of
    # within the projected search window.
    localizing: jnp.ndarray  # bool scalar
    ring: jnp.ndarray  # (RING, RING_W) f32 packed per-frame results
    # --- keyframe machinery (in-graph local-map trigger + snapshots) -----
    # The local-map creation trigger (reference world_map.cpp:108-111) and
    # the keyframe snapshot both run INSIDE the fused step, so the host
    # never drains the pipeline to ask "is this a keyframe?".  Snapshots
    # accumulate in a device-side ring (like the result ring) and are
    # harvested in the same batched readback.
    T_last_kf: jnp.ndarray  # (4, 4) pose at the last window reset
    frames_since_kf: jnp.ndarray  # int32 scalar
    kf_count: jnp.ndarray  # int32 scalar: local maps created so far
    # Device-side landmark slot free-list (stack): recycled slots from
    # eviction (reference framepoint dropping, world_map.cpp:141-160) and
    # merges are drawn before fresh next_slot rows — the map no longer
    # silently saturates at the table capacity.
    free_list: jnp.ndarray  # (F,) int32 stack of recycled slots
    free_count: jnp.ndarray  # int32 scalar
    kf_pose: jnp.ndarray  # (KR, 4, 4) keyframe poses
    kf_frame_idx: jnp.ndarray  # (KR,) int32
    kf_n: jnp.ndarray  # (KR,) int32 valid snapshot rows
    kf_slots: jnp.ndarray  # (KR, K) int32 landmark slots (-1 pad)
    kf_xyz: jnp.ndarray  # (KR, K, 3) landmark world positions at snapshot
    kf_desc: jnp.ndarray  # (KR, K, 8) uint32 landmark descriptors
    kf_uv4: jnp.ndarray  # (KR, K, 4) keyframe observations (BA measurements)


# Ring row layout: flattened pose (16) + stats.  A single host readback of
# the ring harvests many frames in one transfer: every device->host get
# pays a fixed latency regardless of size, which per-frame readbacks (even
# of a scalar) would pay once per frame.
RING_W = 28
_R_POSE = slice(0, 16)
(_R_NKP, _R_NFP, _R_NMATCH, _R_NINL, _R_OK, _R_CHI2, _R_NSPAWN, _R_FIDX,
 _R_KFCOUNT, _R_NRECOVER, _R_STATUS, _R_SPARE) = range(16, 28)


class StepStats(NamedTuple):
    n_keypoints: jnp.ndarray
    n_framepoints: jnp.ndarray
    n_matches: jnp.ndarray
    n_inliers: jnp.ndarray
    tracking_ok: jnp.ndarray
    mean_chi2: jnp.ndarray
    n_spawned: jnp.ndarray


class FusedParams(NamedTuple):
    """Static compile-time parameters of the fused program."""

    capacity: int = 1024
    bin_size: int = 16
    border: int = 20
    mode: str = "stereo"  # stereo | depth
    descriptor: str = "BRIEF256"  # BRIEF256 (dense) | BRIEF256R (dense rotated banks) | ORB256 (gather)
    detector: str = "FAST"  # FAST | FAST12 | AGAST | HARRIS | GFTT
    # Pyramid levels for detection + description (cv::ORB-class
    # multi-scale, base_framepoint_generation.cpp:28-136); 1 = single scale.
    octaves: int = 1
    # Split pipeline: batched chunk front-end + sequential track steps
    # (make_chunk_frontend / make_track_step) instead of one fully-fused
    # per-frame program.
    split_frontend: bool = False
    max_hamming_stereo: int = 60
    epipolar_tol: float = 1.5
    min_disparity: float = 1.0
    max_disparity: float = 200.0
    min_depth: float = 0.3
    max_depth: float = 10.0
    min_track_for_landmark: int = 2
    min_inliers: int = 20
    min_inlier_ratio: float = 0.0  # registration gate (parameters.h:66-95)
    # Retry-ladder depth (reference _registerRecursive <=2 retries,
    # pose_tracker_3d.cpp:300-419).  1 disables retries (benchmarking /
    # odometry-guided configs where the first attempt is reliable).
    retry_attempts: int = 3
    enable_recovery: bool = True  # recoverPoints parity (stereo modes)
    max_recovery_gate: float = 50.0  # descriptor gate cap for recovery
    radius_min: float = 50.0
    radius_max: float = 150.0
    # Adaptive-controller cap for the projection window (reference
    # maximum_threshold_distance_tracking_pixels, parameters.h:283); the
    # retry ladder may still widen to radius_max beyond it.
    radius_adaptive_max: float = 60.0
    # Registration result must track at least this many points or the
    # frame falls back to the motion-model estimate (reference
    # minimum_number_of_landmarks_to_track, pose_tracker_3d.cpp:111,132,364).
    min_landmarks_to_track: int = 5
    # Movement significance gate: optimized deltas below BOTH thresholds
    # are treated as stationary — the motion estimate is not updated
    # (reference pose_tracker_3d.cpp:145,378).
    min_delta_ang: float = 0.001
    min_delta_trans: float = 0.01
    gate_min: float = 60.0
    gate_max: float = 90.0
    good_tracking_ratio: float = 0.3
    target_keypoints: int = 700
    # Controller dead band (reference target_number_of_keypoints_tolerance,
    # parameters.h:163): no threshold adjustment within +-tol of target.
    target_tolerance: float = 0.1
    # LandmarkParameters (reference parameters.h:97-126), passed through to
    # the batched landmark refinement.
    lm_min_forced_updates: int = 0
    lm_min_meas_for_opt: int = 0
    lm_max_t_err_depth_ratio: float = 0.0
    threshold_min: float = 5.0
    threshold_max: float = 100.0
    threshold_max_change: float = 10.0
    ring_size: int = 64  # device-side result ring capacity (frames)
    # Local-map (keyframe) trigger, reference world_map.cpp:108-111.
    kf_min_distance: float = 0.5
    kf_min_radians: float = 0.5236  # 30 deg
    kf_min_frames: int = 4
    kf_min_landmarks: int = 50
    kf_max_landmarks: int = 1024  # snapshot row cap (<= capacity)
    kf_ring_size: int = 32  # keyframe snapshot ring (must cover a drain gap)
    # RGB-D: bilateral smoothing of the registered depth map
    # (depth_framepoint_generator.cpp:415-421).
    bilateral_depth: bool = False
    # Landmark lifecycle (reference framepoint dropping / landmark pruning).
    enable_eviction: bool = True
    evict_every: int = 32  # frames between eviction sweeps
    evict_age_frames: int = 120  # unseen for this long -> candidate
    evict_max_updates: int = 3  # only low-quality (few-observation) slots
    # PROTECTED (local-map-referenced) slots also recycle once unseen this
    # long — permanent protection starves the allocator on long runs (the
    # table saturates and tracking degrades); closure merges are
    # validity-gated so a stale correspondence into a recycled slot is a
    # no-op (reference frees whole old frames under option_drop_framepoints,
    # slam_assembly.cpp:591-618).
    evict_protected_age_frames: int = 600
    free_list_size: int = 16384
    gn_config: gn.GNConfig = gn.GNConfig()


def init_state(cam: cam_ops.CameraParams, params: FusedParams,
               landmark_capacity: int, threshold0: float) -> TrackerState:
    # Snapshot rows are kf_max_landmarks wide (NOT full keypoint
    # capacity): n_snap is clamped there anyway, and every extra column
    # rides the drain readback at every drain (slim drain payloads).
    KR, K = params.kf_ring_size, min(params.kf_max_landmarks, params.capacity)
    return TrackerState(
        prev=frame_mod.empty_frame(params.capacity),
        table=lm_mod.empty_table(landmark_capacity),
        T_world_cam=jnp.eye(4),
        last_motion=jnp.eye(4),
        radius_px=jnp.float32(params.radius_min),
        desc_gate=jnp.float32(params.gate_min),
        threshold=jnp.float32(threshold0),
        next_slot=jnp.int32(0),
        frame_idx=jnp.int32(0),
        has_prev=jnp.asarray(False),
        localizing=jnp.asarray(True),
        ring=jnp.zeros((params.ring_size, RING_W), jnp.float32),
        T_last_kf=jnp.eye(4),
        frames_since_kf=jnp.int32(0),
        kf_count=jnp.int32(0),
        kf_pose=jnp.tile(jnp.eye(4, dtype=jnp.float32), (KR, 1, 1)),
        kf_frame_idx=jnp.full(KR, -1, jnp.int32),
        kf_n=jnp.zeros(KR, jnp.int32),
        kf_slots=jnp.full((KR, K), -1, jnp.int32),
        kf_xyz=jnp.zeros((KR, K, 3), jnp.float32),
        kf_desc=jnp.zeros((KR, K, 8), jnp.uint32),
        kf_uv4=jnp.zeros((KR, K, 4), jnp.float32),
        free_list=jnp.zeros(params.free_list_size, jnp.int32),
        free_count=jnp.int32(0),
    )


# uv4 fixed-point transfer encoding: 1/16-pixel resolution, exact for
# coordinates below 4096 px; halves the observation payload of a drain.
UV4_SCALE = 16.0


@partial(jax.jit, static_argnames=("ship_desc", "ship_uv4", "quant_uv4"))
def gather_kf_rows(kf_pose, kf_frame_idx, kf_n, kf_slots, kf_xyz, kf_desc,
                   kf_uv4, rows, ship_desc: bool = True,
                   ship_uv4: bool = True, quant_uv4: bool = False):
    """Compact the given keyframe ring rows into (len(rows), ...) blocks —
    the harvest then transfers only new snapshots instead of whole rings.

    ship_desc=False / ship_uv4=False replace those blocks (32 B resp.
    8-16 B per landmark — the bundle's largest fields) with (R, 1, ...)
    placeholders: the relocalizer reads descriptors straight from the
    device ring (gather_kf_desc) and BA/viz fetch observations lazily
    (gather_kf_uv4), so neither crosses the ~3 MB/s link per drain.
    quant_uv4 packs observations as 1/16-px uint16 (see UV4_SCALE)."""
    desc = (kf_desc[rows] if ship_desc
            else jnp.zeros((rows.shape[0], 1, 8), jnp.uint32))
    if ship_uv4:
        uv4 = kf_uv4[rows]
        if quant_uv4:
            uv4 = jnp.round(
                jnp.clip(uv4 * UV4_SCALE, 0.0, 65535.0)
            ).astype(jnp.uint16)
    else:
        uv4 = jnp.zeros((rows.shape[0], 1, 4), jnp.uint16)
    return (kf_pose[rows], kf_frame_idx[rows], kf_n[rows], kf_slots[rows],
            kf_xyz[rows], desc, uv4)


@jax.jit
def gather_kf_uv4(kf_uv4, rows):
    """Lazy observation fetch for BA / visualization: ring rows ->
    (R, K, 4) uint16 1/16-px fixed point (decode with /UV4_SCALE).  Runs
    once per new BA-window keyframe instead of riding every drain."""
    return jnp.round(
        jnp.clip(kf_uv4[rows] * UV4_SCALE, 0.0, 65535.0)
    ).astype(jnp.uint16)


@partial(jax.jit, static_argnames=("out_cap",))
def gather_kf_desc(kf_desc, rows, out_cap: int = 1024):
    """Device-side descriptor gather for the relocalizer: ring rows ->
    (R, out_cap, 8) uint32, zero-padded past the snapshot width.  Keeps
    the descriptor blocks OFF the host link entirely (no D2H in the drain
    and no H2D in the DB insert)."""
    R = rows.shape[0]
    out = jnp.zeros((R, out_cap, 8), jnp.uint32)
    return jax.lax.dynamic_update_slice(out, kf_desc[rows], (0, 0, 0))


# Speculative keyframe window shipped with every drain (see drain_bundle).
# Sized for the densest realistic cadence (~1 keyframe per 3 frames at a
# 32-frame drain interval); rarer overflows fall back to an explicit
# gather_kf_rows round trip.  With desc/uv4 device-resident a window row
# is ~2-8 KB and the transfer is an async background copy, so the window
# affords covering the dense case across the lagged-bundle span
# (~2 drains of keyframes).
KF_WINDOW = 32


@partial(jax.jit, static_argnames=("ship_desc", "ship_uv4", "quant_uv4"))
def drain_bundle(state, kf_start, ship_desc: bool = False,
                 ship_uv4: bool = True, quant_uv4: bool = True):
    """The per-drain readback, as ONE transferable bundle: the result ring
    PLUS a speculative window of keyframe-snapshot rows starting at ring
    row `kf_start`.  Every device_get pays a round trip regardless of
    payload, so the drain must not read the ring first and only then fetch
    keyframe rows it learned about —
    rows beyond the actual new-keyframe count are garbage the host
    ignores (the rare >KF_WINDOW overflow falls back to gather_kf_rows)."""
    KR = state.kf_pose.shape[0]
    rows = (kf_start + jnp.arange(KF_WINDOW, dtype=jnp.int32)) % KR
    return (state.ring,) + gather_kf_rows(
        state.kf_pose, state.kf_frame_idx, state.kf_n, state.kf_slots,
        state.kf_xyz, state.kf_desc, state.kf_uv4, rows,
        ship_desc=ship_desc, ship_uv4=ship_uv4, quant_uv4=quant_uv4,
    )


@jax.jit
def push_free_slots(free_list, free_count, slots):
    """Push released slot ids (-1 = skip) onto the device free stack —
    used when landmark merges free absorbed slots."""
    F = free_list.shape[0]
    ok = slots >= 0
    rank = jnp.cumsum(ok.astype(jnp.int32)) - 1
    dest = free_count + rank
    push = ok & (dest < F)
    tgt = jnp.where(push, dest, 0)
    free_list = free_list.at[tgt].add(jnp.where(push, slots - free_list[tgt], 0))
    return free_list, free_count + jnp.sum(push).astype(jnp.int32)


def _front_end(cam, params: FusedParams, state, img_l, img_r,
               depth_calib=None):
    """Returns (frame, n_kp, n_fp, planes) — planes are the dense BRIEF
    descriptor maps (None in ORB mode), kept for landmark recovery.

    depth_calib: optional (K_depth (3,3), T_rgb_depth (4,4)) for a depth
    sensor NOT aligned with the intensity camera — the depth image is
    reprojected/z-buffered into the RGB frame first (reference
    _computeDepthMap, depth_framepoint_generator.cpp:410-484).  NOTE: the
    fused step registers BEFORE calling here (_register_depth_input) so
    recovery sees the same registered map; this parameter serves direct
    callers."""
    want_planes = params.enable_recovery and params.descriptor != "ORB256"
    if params.mode == "stereo":
        out = frame_mod.stereo_frontend_core(
            cam, img_l, img_r, state.threshold,
            jnp.int32(params.max_hamming_stereo),
            jnp.float32(params.epipolar_tol),
            jnp.float32(params.min_disparity),
            jnp.float32(params.max_disparity),
            capacity=params.capacity,
            bin_size=params.bin_size,
            border=params.border,
            descriptor=params.descriptor,
            detector=params.detector,
            want_planes=want_planes,
            octaves=params.octaves,
        )
        if want_planes:
            return out
        return out + (None,)
    if depth_calib is not None:
        from vslam_tpu.frontend import depth as depth_mod

        K_depth, T_rgb_depth = depth_calib
        img_r = depth_mod.register_depth(cam, img_r, K_depth, T_rgb_depth)
    out = frame_mod.process_depth_frame(
        cam, img_l, img_r, state.threshold,
        jnp.float32(params.min_depth), jnp.float32(params.max_depth),
        capacity=params.capacity, bin_size=params.bin_size, border=params.border,
        descriptor=params.descriptor, detector=params.detector,
        want_planes=want_planes, octaves=params.octaves,
    )
    if want_planes:
        return out
    return out + (None,)


def _spawn_and_update(cam, params: FusedParams, state, cur):
    """Device-side landmark allocation + batched refinement.

    Allocation draws recycled slots from the free-list stack first, then
    fresh rows from the next_slot watermark (reference createLandmark,
    world_map.cpp:74-92 — heap allocation becomes a prefix-sum rank)."""
    table = state.table
    cap_lm = table.capacity
    F = state.free_list.shape[0]
    needs = cur.valid & cur.reliable & (cur.landmark_slot < 0) & (
        cur.track_len >= params.min_track_for_landmark
    )
    order = jnp.cumsum(needs.astype(jnp.int32)) - 1  # rank among spawners
    n_needs = jnp.sum(needs).astype(jnp.int32)
    fc = state.free_count
    # Rank r takes free_list[fc-1-r] while r < fc, else next_slot + (r - fc).
    from_free = order < fc
    slot_free = state.free_list[jnp.clip(fc - 1 - order, 0, F - 1)]
    slot_seq = state.next_slot + (order - fc)
    slot = jnp.where(from_free, slot_free, slot_seq)
    slot = jnp.where(needs & (slot < cap_lm) & (slot >= 0), slot, -1).astype(
        jnp.int32
    )
    n_spawned = jnp.sum(slot >= 0).astype(jnp.int32)
    n_from_free = jnp.minimum(n_needs, fc)
    free_count = fc - n_from_free
    next_slot = jnp.minimum(
        state.next_slot + jnp.maximum(n_needs - fc, 0), cap_lm
    ).astype(jnp.int32)

    cur = cur._replace(
        landmark_slot=jnp.where(slot >= 0, slot, cur.landmark_slot)
    )
    # New landmarks belong to the NEXT local map to be created (= kf_count):
    # its window is exactly the frames since the last keyframe.  Spawn +
    # first/next observation update fused into ONE table pass (8 scatters
    # instead of 13).
    table = lm_mod.spawn_and_update_observed(
        cam, table, state.T_world_cam,
        cur.landmark_slot, slot >= 0, cur.p_cam, cur.uv4, cur.desc,
        cur.valid, state.frame_idx, origin_kf=state.kf_count,
        mode=params.mode,
        min_forced_updates=params.lm_min_forced_updates,
        min_meas_for_opt=params.lm_min_meas_for_opt,
        max_t_err_depth_ratio=params.lm_max_t_err_depth_ratio,
    )
    return table, cur, next_slot, n_spawned, free_count


def _step_tail(cam, params: FusedParams, track_fn, state: TrackerState,
               cur, n_kp, n_fp, planes, img_l, img_r, motion_model_on,
               T_odom, use_odom):
    """Everything after the front-end: threshold controller, retry-ladder
    registration, track propagation, temporary-point promotion, landmark
    recovery, spawn/update, keyframe trigger + snapshot, eviction sweep,
    adaptive window, result ring.  Shared by the fully-fused per-frame step
    and the split (batched-frontend) pipeline."""
    # In-graph detector threshold controller
    # (base_framepoint_generator.cpp:440-459).
    err = (n_kp.astype(jnp.float32) - params.target_keypoints) / params.target_keypoints
    # Dead band: inside +-target_tolerance of the target, leave the
    # threshold alone (reference target_number_of_keypoints_tolerance).
    err = jnp.where(jnp.abs(err) <= params.target_tolerance, 0.0, err)
    delta = jnp.clip(err * params.threshold_max_change,
                     -params.threshold_max_change, params.threshold_max_change)
    threshold = jnp.clip(state.threshold + delta,
                         params.threshold_min, params.threshold_max)

    weights = lm_mod.landmark_weights(state.table, state.prev.landmark_slot)
    T_guess = jnp.where(
        use_odom, T_odom,
        jnp.where(motion_model_on, state.last_motion, jnp.eye(4)),
    )

    def attempt(radius, gate, guess):
        return track_fn(
            cam, state.prev, cur, guess, radius, gate.astype(jnp.int32),
            weights, params.gn_config,
        )

    def accept(r):
        # Inlier count AND inlier ratio gates (reference registration
        # acceptance, AlignerParameters parameters.h:66-95).
        ratio = r.n_inliers.astype(jnp.float32) / jnp.maximum(
            r.n_matches.astype(jnp.float32), 1.0
        )
        return (
            r.converged
            & (r.n_inliers >= params.min_inliers)
            & (r.n_inliers >= params.min_landmarks_to_track)
            & (ratio >= params.min_inlier_ratio)
        )

    # Localizing state => first attempt matches BY APPEARANCE: the search
    # window widens past the image (projection-free global Hamming match)
    # with an identity motion guess and the maximum descriptor gate
    # (reference track_by_appearance, pose_tracker_3d.cpp:87-92,227-239).
    appearance = state.localizing & state.has_prev
    res1 = attempt(
        jnp.where(appearance, jnp.float32(1e6), state.radius_px),
        jnp.where(appearance, jnp.float32(params.gate_max), state.desc_gate),
        jnp.where(appearance, jnp.eye(4), T_guess),
    )
    ok1 = accept(res1)
    res = res1

    if params.retry_attempts >= 2:
        def retry2(_):
            return attempt(
                jnp.minimum(2.0 * state.radius_px, params.radius_max),
                jnp.minimum(state.desc_gate + 10.0, params.gate_max),
                T_guess,
            )

        res2 = jax.lax.cond(ok1, lambda _: res1, retry2, None)
        ok2 = accept(res2)
        res = res2

    if params.retry_attempts >= 3:
        def retry3(_):
            return attempt(
                jnp.float32(params.radius_max), jnp.float32(params.gate_max),
                jnp.eye(4),
            )

        res = jax.lax.cond(ok2, lambda _: res2, retry3, None)

    ok = accept(res) & state.has_prev

    motion = jnp.where(ok, res.T_cur_prev, T_guess)
    # Seed frames (first frame / checkpoint resume) dead-reckon on the
    # motion model so the trajectory stays continuous; T_guess is
    # identity at frame 0 (last_motion initializes to identity).
    motion = jnp.where(state.has_prev, motion, T_guess)
    # Movement significance gate (pose_tracker_3d.cpp:145,378): a solved
    # delta below both thresholds is jitter around a stationary camera —
    # snap it to identity so the pose (and the motion model) hold still.
    d_ang = lie.rotation_angle(motion[:3, :3])
    d_trans = jnp.linalg.norm(motion[:3, 3])
    stationary = (
        ok & (d_ang < params.min_delta_ang) & (d_trans < params.min_delta_trans)
    )
    motion = jnp.where(stationary, jnp.eye(4, dtype=motion.dtype), motion)
    T_world_cam = state.T_world_cam @ lie.inverse(motion)

    # Track propagation only on success (reference breakTrack otherwise).
    prop = frame_mod.propagate_tracks(state.prev, cur, res.prev_to_cur)
    cur = jax.tree.map(lambda a, b: jnp.where(ok, a, b), prop, cur)

    # Temporary-point promotion: tracked low-disparity points gain 3D
    # from midpoint triangulation once motion gives them parallax.
    cur, n_promoted = frame_mod.promote_temporary_points(
        cam, state.prev, cur, motion, res.prev_to_cur, enabled=ok,
    )

    # Landmark recovery (recoverPoints parity): lost landmark-backed
    # points are re-acquired at their solved-pose projections.
    n_recovered = jnp.int32(0)
    if params.enable_recovery and params.mode == "stereo":
        cur, n_recovered = frame_mod.recover_lost_landmarks(
            cam, state.prev, cur, motion, res.prev_to_cur, planes,
            img_l, img_r,
            jnp.minimum(state.desc_gate, params.max_recovery_gate),
            jnp.float32(params.min_disparity),
            jnp.float32(params.max_disparity),
            border=params.border,
            descriptor=params.descriptor,
            enabled=ok,
        )
    elif params.enable_recovery and params.mode == "depth":
        cur, n_recovered = frame_mod.recover_lost_landmarks_depth(
            cam, state.prev, cur, motion, res.prev_to_cur, planes,
            img_l, img_r,
            jnp.minimum(state.desc_gate, params.max_recovery_gate),
            jnp.float32(params.min_depth),
            jnp.float32(params.max_depth),
            border=params.border,
            descriptor=params.descriptor,
            enabled=ok,
        )

    new_state = state._replace(T_world_cam=T_world_cam)
    table, cur, next_slot, n_spawned, free_count = _spawn_and_update(
        cam, params, new_state, cur
    )

    # ---- in-graph local-map trigger + keyframe snapshot --------------
    # (reference world_map.cpp:108-111 + LocalMap ctor local_map.cpp:27-96)
    dT = lie.inverse(state.T_last_kf) @ T_world_cam
    kf_dist = jnp.linalg.norm(dT[:3, 3])
    kf_ang = lie.rotation_angle(dT[:3, :3])
    frames_since = state.frames_since_kf + 1
    geo_trigger = state.has_prev & (
        (kf_ang > params.kf_min_radians)
        | ((kf_dist > params.kf_min_distance)
           & (frames_since >= params.kf_min_frames))
    )
    lm_backed = cur.valid & (cur.landmark_slot >= 0)
    n_lm_backed = jnp.sum(lm_backed).astype(jnp.int32)
    fire = geo_trigger & (n_lm_backed >= params.kf_min_landmarks)
    # The window resets whenever the geometric trigger fires — even if
    # too few landmarks existed to snapshot (keeps the trigger from
    # re-firing every subsequent frame; the reference keeps its window
    # open, we postpone by kf_min_frames).
    T_last_kf = jnp.where(geo_trigger, T_world_cam, state.T_last_kf)
    frames_since = jnp.where(geo_trigger, 0, frames_since)

    def take_snapshot(args):
        kf_pose, kf_fidx, kf_n, kf_slots, kf_xyz, kf_desc, kf_uv4, prot = args
        KW = kf_slots.shape[1]  # snapshot row width (= kf_max_landmarks)
        n_snap = jnp.minimum(n_lm_backed, KW)
        perm = frame_mod.stable_partition_perm(lm_backed)[:KW]
        rank = jnp.arange(KW)
        slots_s = jnp.where(rank < n_snap, cur.landmark_slot[perm], -1)
        g = jnp.maximum(slots_s, 0)
        row = state.kf_count % params.kf_ring_size
        upd = jax.lax.dynamic_update_slice
        kf_pose = upd(kf_pose, T_world_cam[None].astype(kf_pose.dtype),
                      (row, 0, 0))
        kf_fidx = kf_fidx.at[row].set(state.frame_idx)
        kf_n = kf_n.at[row].set(n_snap)
        kf_slots = upd(kf_slots, slots_s[None], (row, 0))
        kf_xyz = upd(kf_xyz, table.xyz_w[g][None], (row, 0, 0))
        kf_desc = upd(kf_desc, table.desc[g][None], (row, 0, 0))
        kf_uv4 = upd(kf_uv4, cur.uv4[perm][None], (row, 0, 0))
        # Snapshotted slots are referenced by the local map / closure DB
        # from now on: protect them from recycling.
        prot = prot.at[g].max(slots_s >= 0)
        return kf_pose, kf_fidx, kf_n, kf_slots, kf_xyz, kf_desc, kf_uv4, prot

    kf_args = (state.kf_pose, state.kf_frame_idx, state.kf_n,
               state.kf_slots, state.kf_xyz, state.kf_desc, state.kf_uv4,
               table.protected)
    (kf_pose, kf_fidx, kf_n, kf_slots, kf_xyz, kf_desc, kf_uv4, prot) = (
        jax.lax.cond(fire, take_snapshot, lambda a: a, kf_args)
    )
    table = table._replace(protected=prot)
    kf_count = state.kf_count + fire.astype(jnp.int32)

    # ---- landmark eviction sweep (framepoint dropping parity) --------
    # Stale low-quality unprotected slots are invalidated and pushed on
    # the free stack; protected (local-map-referenced) and live-tracked
    # slots never recycle.
    free_list = state.free_list
    if params.enable_eviction:
        F = free_list.shape[0]

        def evict(args):
            table_, free_list_, free_count_ = args
            age = state.frame_idx - table_.last_seen
            referenced = (
                jnp.zeros(table_.capacity, bool)
                .at[jnp.maximum(cur.landmark_slot, 0)]
                .max(cur.landmark_slot >= 0)
            )
            cand_unprot = (
                ~table_.protected
                & (age > params.evict_age_frames)
                & (table_.n_updates <= params.evict_max_updates)
            )
            cand_prot = table_.protected & (
                age > params.evict_protected_age_frames
            )
            cand = table_.valid & ~referenced & (cand_unprot | cand_prot)
            rank = jnp.cumsum(cand.astype(jnp.int32)) - 1
            dest = free_count_ + rank
            push = cand & (dest < F)
            n_push = jnp.sum(push).astype(jnp.int32)
            # Compact pushed slot ids to the front with ONE sort and a
            # gather-merge instead of a capacity-row scatter into the
            # stack.
            ids = jnp.arange(table_.capacity, dtype=jnp.int32)
            key = jnp.where(push, ids, jnp.int32(table_.capacity))
            pushed_ids, _ = jax.lax.sort_key_val(key, ids)
            # Stack position p takes: old value below free_count, the
            # (p - free_count)-th pushed id in the appended window, old
            # value above it.
            pos = jnp.arange(F, dtype=jnp.int32)
            appended = pushed_ids[
                jnp.clip(pos - free_count_, 0, table_.capacity - 1)
            ]
            in_window = (pos >= free_count_) & (pos < free_count_ + n_push)
            free_list_ = jnp.where(in_window, appended, free_list_)
            free_count_ = free_count_ + n_push
            table_ = table_._replace(
                valid=table_.valid & ~push,
                protected=table_.protected & ~push,
            )
            return table_, free_list_, free_count_

        do_sweep = (state.frame_idx % params.evict_every) == (
            params.evict_every - 1
        )
        table, free_list, free_count = jax.lax.cond(
            do_sweep, evict, lambda a: a, (table, free_list, free_count)
        )

    # Adaptive search window (pose_tracker_3d.cpp:251-288).
    n_prev = jnp.maximum(jnp.sum(state.prev.valid), 1)
    ratio = res.n_matches.astype(jnp.float32) / n_prev.astype(jnp.float32)
    poor = ratio < params.good_tracking_ratio
    radius = jnp.where(
        poor,
        jnp.minimum(state.radius_px * 1.2, params.radius_adaptive_max),
        jnp.maximum(state.radius_px * 0.95, params.radius_min),
    )
    gate = jnp.where(poor, jnp.minimum(state.desc_gate + 5.0, params.gate_max),
                     jnp.maximum(state.desc_gate - 1.0, params.gate_min))

    row = jnp.concatenate([
        T_world_cam.reshape(16),
        jnp.stack([
            n_kp.astype(jnp.float32),
            n_fp.astype(jnp.float32),
            res.n_matches.astype(jnp.float32),
            res.n_inliers.astype(jnp.float32),
            (ok | ~state.has_prev).astype(jnp.float32),
            res.mean_chi2.astype(jnp.float32),
            n_spawned.astype(jnp.float32),
            state.frame_idx.astype(jnp.float32),
            kf_count.astype(jnp.float32),
            n_recovered.astype(jnp.float32),  # _R_NRECOVER
            ok.astype(jnp.float32),  # _R_STATUS (1 = Tracking)
            jnp.float32(0.0),  # _R_SPARE
        ]),
    ])
    ring = jax.lax.dynamic_update_slice(
        state.ring, row[None, :], (state.frame_idx % params.ring_size, 0)
    )

    out = TrackerState(
        prev=cur,
        table=table,
        T_world_cam=T_world_cam,
        last_motion=jnp.where(state.has_prev, motion, state.last_motion),
        radius_px=radius,
        desc_gate=gate,
        threshold=threshold,
        next_slot=next_slot,
        frame_idx=state.frame_idx + 1,
        has_prev=jnp.asarray(True),
        localizing=~ok,
        ring=ring,
        T_last_kf=T_last_kf,
        frames_since_kf=frames_since,
        kf_count=kf_count,
        kf_pose=kf_pose,
        kf_frame_idx=kf_fidx,
        kf_n=kf_n,
        kf_slots=kf_slots,
        kf_xyz=kf_xyz,
        kf_desc=kf_desc,
        kf_uv4=kf_uv4,
        free_list=free_list,
        free_count=free_count,
    )
    stats = StepStats(
        n_keypoints=n_kp,
        n_framepoints=n_fp,
        n_matches=res.n_matches,
        n_inliers=res.n_inliers,
        tracking_ok=ok | ~state.has_prev,
        mean_chi2=res.mean_chi2,
        n_spawned=n_spawned,
    )
    return out, stats


def _register_depth_input(cam, params: FusedParams, img_r, depth_calib):
    """Reproject a misaligned depth image into the RGB frame (no-op in
    stereo mode or when the sensors are already aligned) and optionally
    bilateral-smooth it (depth_framepoint_generator.cpp:415-421)."""
    if params.mode != "depth":
        return img_r
    from vslam_tpu.frontend import depth as depth_mod

    if depth_calib is not None:
        K_depth, T_rgb_depth = depth_calib
        img_r = depth_mod.register_depth(cam, img_r, K_depth, T_rgb_depth)
    if params.bilateral_depth:
        img_r = depth_mod.bilateral_filter_depth(img_r)
    return img_r


def _memo_key(params: FusedParams, depth_calib):
    """Cache key for the step builders: params is a hashable NamedTuple;
    the depth-calibration device arrays key by value."""
    if depth_calib is None:
        return (params, None)
    K_d, T_d = depth_calib
    return (params, np.asarray(K_d).tobytes(), np.asarray(T_d).tobytes())


def _memoized(builder):
    """Return the SAME jitted step for identical (params, calib): a second
    tracker instance (bench warmup vs timed run, engine restarts) then
    reuses the in-memory jit cache instead of re-tracing the full fused
    program (~6 s on the closed-loop bench)."""
    cache: dict = {}

    def build(params: FusedParams, depth_calib=None):
        key = _memo_key(params, depth_calib)
        if key not in cache:
            cache[key] = builder(params, depth_calib)
        return cache[key]

    return build


@_memoized
def make_frame_step(params: FusedParams, depth_calib=None):
    """Build the fully-fused per-frame step specialized to static params.

    The returned `step(cam, state, chunk, idx, motion_model_on, odom_chunk,
    use_odom)` processes one frame entirely on device and returns
    (new_state, stats).

    chunk: (C, 2, H, W) — uint8 (stereo pairs) or f32 (intensity +
    depth_m); idx selects this step's frame.  Frames are uploaded in
    C-frame chunks so that one upload's fixed latency is amortized across
    C frames.
    odom_chunk: (C, 4, 4) external odometry guesses (CAMERA_ODOMETRY
    motion model, pose_tracker_3d.cpp:41-66), selected by use_odom.

    NOTE: no buffer donation — the batched ring readback holds references
    to prior states while steps are in flight; donating the state would
    free those buffers mid-read.  State is ~tens of MB, so double-buffering
    is cheap.
    """

    track_fn = (
        frame_mod.track_and_align
        if params.mode == "stereo"
        else frame_mod.track_and_align_uvd
    )

    @jax.jit
    def step(cam, state: TrackerState, chunk, idx, motion_model_on,
             odom_chunk, use_odom):
        imgs = jax.lax.dynamic_index_in_dim(chunk, idx, 0, keepdims=False)
        img_l = imgs[0].astype(jnp.float32)
        img_r = _register_depth_input(
            cam, params, imgs[1].astype(jnp.float32), depth_calib
        )
        cur, n_kp, n_fp, planes = _front_end(cam, params, state, img_l, img_r)
        T_odom = jax.lax.dynamic_index_in_dim(odom_chunk, idx, 0, keepdims=False)
        return _step_tail(cam, params, track_fn, state, cur, n_kp, n_fp,
                          planes, img_l, img_r, motion_model_on, T_odom,
                          use_odom)

    return step


@_memoized
def make_chunk_step(params: FusedParams, depth_calib=None):
    """ONE dispatch per frame chunk: the k per-frame fused steps run as a
    single XLA program — a `lax.fori_loop` whose body is exactly the
    make_frame_step body (same `_front_end` + `_step_tail`, so the two
    paths cannot diverge; equivalence pinned by
    tests/test_fused.py::test_chunk_step_matches_per_frame_steps).

    Motivation: with per-frame dispatch the host issues k jitted calls
    per chunk, each paying pytree flatten + launch overhead.  Rolling the
    chunk into one program makes dispatch cost O(1) per chunk.  `k` is a
    traced scalar (the tail chunk of a run is shorter), so one compiled
    program serves every chunk length.

    This replaces the reference's serial per-frame loop
    (slam_assembly.cpp:361-489) at the dispatch level; the per-frame
    sequential semantics are preserved exactly by the loop carry.
    """
    track_fn = (
        frame_mod.track_and_align
        if params.mode == "stereo"
        else frame_mod.track_and_align_uvd
    )

    @jax.jit
    def chunk_step(cam, state: TrackerState, chunk, k, motion_model_on,
                   odom_chunk, use_odom):
        def body(i, st):
            imgs = jax.lax.dynamic_index_in_dim(chunk, i, 0, keepdims=False)
            img_l = imgs[0].astype(jnp.float32)
            img_r = _register_depth_input(
                cam, params, imgs[1].astype(jnp.float32), depth_calib
            )
            # Named scope: profiler traces attribute the front-end's
            # kernels by it (scripts/frontend_decomp.py).
            with jax.named_scope("frontend"):
                cur, n_kp, n_fp, planes = _front_end(cam, params, st, img_l,
                                                     img_r)
            T_odom = jax.lax.dynamic_index_in_dim(
                odom_chunk, i, 0, keepdims=False
            )
            new_st, _ = _step_tail(cam, params, track_fn, st, cur, n_kp,
                                   n_fp, planes, img_l, img_r,
                                   motion_model_on, T_odom, use_odom)
            return new_st

        return jax.lax.fori_loop(0, k, body, state)

    return chunk_step


@_memoized
def make_chunk_frontend(params: FusedParams, depth_calib=None):
    """Batched front-end over a whole frame chunk — the data-parallel
    half of the split pipeline (SURVEY §2.9 "batch/data parallelism of the
    front-end"): detection, description and stereo matching for all C
    frames run as ONE vmapped XLA program (bigger convolutions and Hamming
    matmuls = better device utilization than C sequential launches), and the
    batch dimension is shardable across a device mesh.

    Returns jitted `frontend(cam, threshold, chunk) -> (frames (C-batched
    FrameState), n_kp (C,), n_fp (C,), planes (C, 2, 8, H, W) | None)`.
    The detector threshold is shared across the chunk (the sequential
    controller still updates it chunk-to-chunk via the track steps).
    """
    @jax.jit
    def frontend(cam, threshold, chunk):
        return jax.vmap(
            lambda pair: _frontend_one(cam, params, threshold, pair,
                                       depth_calib)
        )(chunk)

    return frontend


def _frontend_one(cam, params: FusedParams, threshold, pair, depth_calib):
    """Per-frame front-end body of the batched (split) pipeline — shared
    by make_chunk_frontend and make_chunk_step_split so the two cannot
    diverge.  Returns (FrameState, n_kp, n_fp, planes|None)."""
    want_planes = params.enable_recovery and params.descriptor != "ORB256"
    img_l = pair[0].astype(jnp.float32)
    img_r = _register_depth_input(
        cam, params, pair[1].astype(jnp.float32), depth_calib
    )
    if params.mode == "stereo":
        out = frame_mod.stereo_frontend_core(
            cam, img_l, img_r, threshold,
            jnp.int32(params.max_hamming_stereo),
            jnp.float32(params.epipolar_tol),
            jnp.float32(params.min_disparity),
            jnp.float32(params.max_disparity),
            capacity=params.capacity,
            bin_size=params.bin_size,
            border=params.border,
            descriptor=params.descriptor,
            detector=params.detector,
            want_planes=want_planes,
            octaves=params.octaves,
        )
        return out if want_planes else out + (None,)
    out = frame_mod.process_depth_frame(
        cam, img_l, img_r, threshold,
        jnp.float32(params.min_depth), jnp.float32(params.max_depth),
        capacity=params.capacity, bin_size=params.bin_size,
        border=params.border, descriptor=params.descriptor,
        detector=params.detector, want_planes=want_planes,
        octaves=params.octaves,
    )
    return out if want_planes else out + (None,)


@_memoized
def make_chunk_step_split(params: FusedParams, depth_calib=None):
    """One-dispatch-per-chunk variant of the SPLIT pipeline: the batched
    (vmapped) front-end for all k frames and the fori_loop over the
    sequential tracking tail run as a single XLA program.  Same
    semantics as make_chunk_frontend + k make_track_step calls (the
    detector threshold is shared across the chunk, exactly as in the
    dispatched split path); one launch instead of k+1."""
    track_fn = (
        frame_mod.track_and_align
        if params.mode == "stereo"
        else frame_mod.track_and_align_uvd
    )

    @jax.jit
    def chunk_step(cam, state: TrackerState, chunk, k, motion_model_on,
                   odom_chunk, use_odom):
        frames_b, n_kp_b, n_fp_b, planes_b = jax.vmap(
            lambda pair: _frontend_one(cam, params, state.threshold, pair,
                                       depth_calib)
        )(chunk)

        def body(i, st):
            pick = lambda a: jax.lax.dynamic_index_in_dim(
                a, i, 0, keepdims=False
            )
            cur = jax.tree.map(pick, frames_b)
            planes = None if planes_b is None else pick(planes_b)
            imgs = pick(chunk)
            img_l = imgs[0].astype(jnp.float32)
            img_r = _register_depth_input(
                cam, params, imgs[1].astype(jnp.float32), depth_calib
            )
            new_st, _ = _step_tail(
                cam, params, track_fn, st, cur, pick(n_kp_b), pick(n_fp_b),
                planes, img_l, img_r, motion_model_on, pick(odom_chunk),
                use_odom,
            )
            return new_st

        return jax.lax.fori_loop(0, k, body, state)

    return chunk_step


@_memoized
def make_track_step(params: FusedParams, depth_calib=None):
    """The sequential half of the split pipeline: consumes one precomputed
    FrameState (+ descriptor planes) from the chunk front-end and runs the
    tracking/mapping tail — identical semantics to make_frame_step by
    construction (same _step_tail)."""
    track_fn = (
        frame_mod.track_and_align
        if params.mode == "stereo"
        else frame_mod.track_and_align_uvd
    )

    @jax.jit
    def track_step(cam, state: TrackerState, frames_batch, n_kp_b, n_fp_b,
                   planes_batch, chunk, idx, motion_model_on, odom_chunk,
                   use_odom):
        pick = lambda a: jax.lax.dynamic_index_in_dim(a, idx, 0, keepdims=False)
        cur = jax.tree.map(pick, frames_batch)
        n_kp = pick(n_kp_b)
        n_fp = pick(n_fp_b)
        planes = None if planes_batch is None else pick(planes_batch)
        imgs = pick(chunk)
        img_l = imgs[0].astype(jnp.float32)
        img_r = _register_depth_input(
            cam, params, imgs[1].astype(jnp.float32), depth_calib
        )
        T_odom = pick(odom_chunk)
        return _step_tail(cam, params, track_fn, state, cur, n_kp, n_fp,
                          planes, img_l, img_r, motion_model_on, T_odom,
                          use_odom)

    return track_step
