"""Per-frame odometry: the host-side state machine driving device kernels.

The array-program PoseTracker3D (reference src/position_tracking/
pose_tracker_3d.cpp): motion-model guess, Localizing/Tracking states,
registration with adaptive-search retries (`_registerRecursive`,
pose_tracker_3d.cpp:300-419), adaptive tracking window and descriptor gate
(:251-288), landmark creation/update (:475-549) and fallback estimation
(:551-566).  All O(N) math happens in the three fused jit programs of
mapping/frame.py + mapping/landmarks.py; this class only makes scalar
decisions, so per-frame host<->device traffic is a handful of scalars.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from vslam_tpu.frontend import detect as detect_mod
from vslam_tpu.io.config import ParameterCollection
from vslam_tpu.mapping import frame as frame_mod
from vslam_tpu.mapping import landmarks as lm_mod
from vslam_tpu.ops import camera as cam_ops
from vslam_tpu.ops import lie
from vslam_tpu.solve import gn

LOCALIZING = "Localizing"
TRACKING = "Tracking"


def _depth_calibration(fp):
    """Optional misaligned-depth-sensor calibration from config:
    (K_depth (3,3), T_rgb_depth (4,4)) device arrays, or None when the
    depth image is already registered to the RGB camera."""
    if fp.depth_camera_intrinsics is None or fp.depth_camera_to_rgb is None:
        return None
    return (
        jnp.asarray(np.asarray(fp.depth_camera_intrinsics, np.float32).reshape(3, 3)),
        jnp.asarray(np.asarray(fp.depth_camera_to_rgb, np.float32).reshape(4, 4)),
    )


@dataclass
class KeyframeSnapshot:
    """One harvested keyframe event from the fused tracker's device-side
    snapshot ring (the engine turns these into LocalMaps + closure work).

    All arrays are host numpy, already truncated to the n valid rows and
    already in the CURRENT (correction-adjusted) world frame."""

    map_id: int  # local-map index (device kf_count order)
    frame_idx: int
    T_world_kf: np.ndarray  # (4, 4)
    slots: np.ndarray  # (n,) int32 landmark table slots
    xyz_w: np.ndarray  # (n, 3) landmark world positions at snapshot
    # Descriptors normally stay ON DEVICE (ring_row points at the live
    # snapshot-ring row; the relocalizer gathers them device-side —
    # fused.gather_kf_desc).  The host copy is populated only by paths
    # that already have it (modular tracker / sharded-DB mode).
    desc: np.ndarray | None  # (n, 8) uint32, or None (device-resident)
    uv4: np.ndarray  # (n, 4) keyframe stereo observations (BA measurements)
    ring_row: int = -1  # device snapshot-ring row (-1: not ring-backed)


@dataclass
class TrackerStats:
    n_frames: int = 0
    n_tracked_points: int = 0
    n_inliers: int = 0
    n_keypoints: int = 0
    n_framepoints: int = 0
    tracking_ratio: float = 0.0
    n_breaks: int = 0
    n_recovered: int = 0  # landmarks re-acquired by recoverPoints parity
    n_spawned: int = 0  # landmarks created over the whole run
    stage_seconds: dict = field(default_factory=dict)

    def add_time(self, stage: str, dt: float):
        self.stage_seconds[stage] = self.stage_seconds.get(stage, 0.0) + dt


class PoseTracker:
    def __init__(
        self,
        cam: cam_ops.CameraParams,
        config: ParameterCollection,
        landmark_capacity: int = 65536,
    ):
        self.cam = cam
        self.cfg = config
        fp = config.framepoint_generation
        tr = config.tracking

        self.capacity = fp.capacity
        n_cells = (cam.rows // fp.bin_size_pixels) * (cam.cols // fp.bin_size_pixels)
        # Target must stay below the fixed capacity: detected counts are
        # clipped at capacity, and a target above it drives the controller's
        # error permanently negative, slamming the threshold to its minimum
        # (noise corners everywhere).
        self.controller = detect_mod.ThresholdController(
            initial=fp.detector_threshold_starting_value,
            target_count=min(int(n_cells * 0.7), int(fp.capacity * 0.7)),
            max_change=fp.detector_threshold_maximum_change,
            minimum=fp.detector_threshold_minimum,
            maximum=fp.detector_threshold_maximum,
        )
        self.gn_config = gn.GNConfig(
            max_iterations=tr.aligner_maximum_number_of_iterations,
            kernel_max_error=tr.aligner_maximum_error_kernel,
            damping=tr.aligner_damping,
            min_num_inliers=tr.aligner_minimum_number_of_inliers,
        )

        # Adaptive search state (reference pose_tracker_3d.cpp:251-288).
        self.radius_px = float(tr.minimum_threshold_distance_tracking_pixels)
        self.desc_gate = float(fp.matching_distance_tracking_threshold)

        self.table = lm_mod.empty_table(landmark_capacity)
        self.allocator = lm_mod.SlotAllocator(landmark_capacity)

        # RGB_STEREO | RGB_DEPTH (reference tracker_mode, parameters.h:40)
        self.mode = (
            "depth" if config.command_line.tracker_mode == "RGB_DEPTH" else "stereo"
        )
        self.status = LOCALIZING
        self.prev_frame: frame_mod.FrameState | None = None
        self.T_world_cam = np.eye(4, dtype=np.float32)
        self.last_motion = np.eye(4, dtype=np.float32)  # T_cur_prev estimate
        self.frame_idx = 0
        self.stats = TrackerStats()
        self.trajectory: list[np.ndarray] = []
        # Owning local-map id for newly spawned landmarks; the engine bumps
        # this when it creates a local map (synchronous keyframe path).
        self.kf_count = 0
        self._break_frames: list[int] = []

    # ------------------------------------------------------------------
    def _front_end(self, img_l, img_r):
        """img_r is the right image in stereo mode, the registered depth
        map (meters) in depth mode."""
        fp = self.cfg.framepoint_generation
        if self.mode == "stereo":
            frame, n_kp, n_fp = frame_mod.process_stereo_pair(
                self.cam,
                jnp.asarray(img_l, jnp.float32),
                jnp.asarray(img_r, jnp.float32),
                jnp.float32(self.controller.threshold),
                jnp.int32(fp.maximum_matching_distance_triangulation),
                jnp.float32(fp.maximum_epipolar_search_offset_pixels),
                jnp.float32(fp.minimum_disparity_pixels),
                jnp.float32(fp.maximum_disparity_pixels),
                capacity=fp.capacity,
                bin_size=fp.bin_size_pixels,
                border=fp.border_pixels,
                descriptor=fp.descriptor_type,
                detector=fp.detector_type,
                octaves=fp.detector_number_of_octaves,
            )
        else:
            depth = jnp.asarray(img_r, jnp.float32)
            calib = _depth_calibration(fp)
            if calib is not None:
                from vslam_tpu.frontend import depth as depth_mod

                depth = depth_mod.register_depth(self.cam, depth, *calib)
            frame, n_kp, n_fp = frame_mod.process_depth_frame(
                self.cam,
                jnp.asarray(img_l, jnp.float32),
                depth,
                jnp.float32(self.controller.threshold),
                jnp.float32(fp.minimum_depth_meters),
                jnp.float32(fp.maximum_depth_meters),
                capacity=fp.capacity,
                bin_size=fp.bin_size_pixels,
                border=fp.border_pixels,
                descriptor=fp.descriptor_type,
                detector=fp.detector_type,
                octaves=fp.detector_number_of_octaves,
            )
        n_kp = int(n_kp)
        self.controller.update(n_kp)
        return frame, n_kp, int(n_fp)

    def _register(self, cur_frame, T_guess):
        """Adaptive-retry registration (reference _registerRecursive:
        <=2 retries with widened window, then identity guess)."""
        tr = self.cfg.tracking
        weights = lm_mod.landmark_weights(self.table, self.prev_frame.landmark_slot)
        attempts = [
            (self.radius_px, self.desc_gate, T_guess),
            (min(2.0 * self.radius_px, tr.maximum_distance_tracking_pixels),
             min(self.desc_gate + 10, 90.0), T_guess),
            (tr.maximum_distance_tracking_pixels, 90.0, np.eye(4, dtype=np.float32)),
        ]
        track_fn = (
            frame_mod.track_and_align
            if self.mode == "stereo"
            else frame_mod.track_and_align_uvd
        )
        for radius, gate, guess in attempts:
            res = track_fn(
                self.cam,
                self.prev_frame,
                cur_frame,
                jnp.asarray(guess),
                jnp.float32(radius),
                jnp.int32(int(gate)),
                weights,
                self.gn_config,
            )
            n_inl = int(res.n_inliers)
            inl_ratio = n_inl / max(int(res.n_matches), 1)
            if (
                bool(res.converged)
                and n_inl >= tr.aligner_minimum_number_of_inliers
                and inl_ratio >= tr.aligner_minimum_inlier_ratio
            ):
                return res, True
        return res, False

    def _adapt_search(self, tracking_ratio: float):
        """Grow the window when tracking is poor, shrink when strong
        (reference pose_tracker_3d.cpp:251-288)."""
        tr = self.cfg.tracking
        if tracking_ratio < tr.good_tracking_ratio:
            self.radius_px = min(self.radius_px * 1.2, tr.maximum_distance_tracking_pixels)
            self.desc_gate = min(self.desc_gate + 5, 90.0)
        else:
            self.radius_px = max(self.radius_px * 0.95,
                                 tr.minimum_threshold_distance_tracking_pixels)
            self.desc_gate = max(self.desc_gate - 1,
                                 self.cfg.framepoint_generation.matching_distance_tracking_threshold)

    def _spawn_and_update_landmarks(self, cur_frame):
        """Create landmarks for mature tracks; refine all observed ones
        (reference _updatePoints, pose_tracker_3d.cpp:475-549)."""
        tr = self.cfg.tracking
        track_len = np.asarray(cur_frame.track_len)
        lm_slot = np.asarray(cur_frame.landmark_slot)
        valid = np.asarray(cur_frame.valid)

        reliable = np.asarray(cur_frame.reliable)
        needs = (
            valid & reliable & (lm_slot < 0)
            & (track_len >= tr.minimum_track_length_for_landmark_creation)
        )
        rows = np.flatnonzero(needs)
        T_wc = jnp.asarray(self.T_world_cam)
        if len(rows):
            slots = self.allocator.allocate(len(rows))
            ok = slots >= 0
            rows, slots = rows[ok], slots[ok]
            if len(rows):
                # Fixed-capacity assignment array (one shape for all frames
                # — variable-length scatters would recompile every frame).
                assigned = np.full(self.capacity, -1, np.int32)
                assigned[rows] = slots
                assigned_dev = jnp.asarray(assigned)
                xyz_w_all = lie.transform_point_cloud(T_wc, cur_frame.p_cam)
                self.table = lm_mod.spawn_landmarks(
                    self.table,
                    assigned_dev,
                    xyz_w_all,
                    cur_frame.desc,
                    jnp.int32(self.frame_idx),
                    origin_kf=jnp.int32(self.kf_count),
                )
                new_slots = jnp.where(
                    assigned_dev >= 0, assigned_dev, cur_frame.landmark_slot
                )
                cur_frame = cur_frame._replace(landmark_slot=new_slots)

        self.table = lm_mod.update_observed(
            self.cam,
            self.table,
            T_wc,
            cur_frame.landmark_slot,
            cur_frame.uv4,
            cur_frame.desc,
            cur_frame.valid,
            jnp.int32(self.frame_idx),
            mode=self.mode,
        )
        return cur_frame

    # ------------------------------------------------------------------
    def compute(
        self,
        img_l: np.ndarray,
        img_r: np.ndarray,
        odometry: np.ndarray | None = None,
    ) -> np.ndarray:
        """Process one stereo pair; returns T_world_cam (4,4) numpy.

        odometry: optional external motion guess T_cur_prev (CAMERA_ODOMETRY
        motion model, reference pose_tracker_3d.cpp:41-66)."""
        tr = self.cfg.tracking
        t0 = time.perf_counter()
        cur_frame, n_kp, n_fp = self._front_end(img_l, img_r)
        self.stats.add_time("frontend", time.perf_counter() - t0)
        self.stats.n_keypoints += n_kp
        self.stats.n_framepoints += n_fp

        if self.prev_frame is None:
            self.status = LOCALIZING
            if self.frame_idx > 0 and tr.motion_model == "CONSTANT_VELOCITY":
                # Re-seeding mid-run (checkpoint resume / track loss):
                # dead-reckon one step so the trajectory stays continuous.
                self.T_world_cam = (
                    self.T_world_cam @ np.linalg.inv(self.last_motion)
                ).astype(np.float32)
            cur_frame = self._spawn_and_update_landmarks(cur_frame)
            self.prev_frame = cur_frame
            self._finish_frame()
            return self.T_world_cam

        # Motion model (reference pose_tracker_3d.cpp:41-66).
        if odometry is not None and (
            tr.motion_model == "CAMERA_ODOMETRY"
            or self.cfg.command_line.option_use_odometry
        ):
            T_guess = np.asarray(odometry, np.float32)
        elif tr.motion_model == "CONSTANT_VELOCITY":
            T_guess = self.last_motion
        else:
            T_guess = np.eye(4, dtype=np.float32)

        t0 = time.perf_counter()
        res, ok = self._register(cur_frame, T_guess)
        self.stats.add_time("tracking", time.perf_counter() - t0)

        n_prev = int(np.sum(np.asarray(self.prev_frame.valid)))
        n_matches = int(res.n_matches)
        ratio = n_matches / max(n_prev, 1)
        self.stats.n_tracked_points += n_matches
        self.stats.n_inliers += int(res.n_inliers)
        self.stats.tracking_ratio = ratio

        if ok:
            motion = np.asarray(res.T_cur_prev)
            self.status = TRACKING
        else:
            # Fallback: dead-reckon on the motion model and re-root tracks
            # (reference breakTrack, world_map.cpp:260-279).
            motion = T_guess
            self.status = LOCALIZING
            self.stats.n_breaks += 1
            self._break_frames.append(self.frame_idx)

        self.T_world_cam = (self.T_world_cam @ np.linalg.inv(motion)).astype(np.float32)
        self.last_motion = motion.astype(np.float32)

        t0 = time.perf_counter()
        if ok:
            cur_frame = frame_mod.propagate_tracks(self.prev_frame, cur_frame, res.prev_to_cur)
            cur_frame, _ = frame_mod.promote_temporary_points(
                self.cam, self.prev_frame, cur_frame,
                jnp.asarray(motion), res.prev_to_cur,
            )
        cur_frame = self._spawn_and_update_landmarks(cur_frame)
        self.stats.add_time("mapping", time.perf_counter() - t0)

        self._adapt_search(ratio)
        self.prev_frame = cur_frame
        self._finish_frame()
        return self.T_world_cam

    def _finish_frame(self):
        self.trajectory.append(self.T_world_cam.copy())
        self.frame_idx += 1
        self.stats.n_frames += 1


class _AllocatorView:
    """Allocator facade over the fused tracker's device slot counter and
    device free-list (allocation and eviction both happen in-graph)."""

    def __init__(self, owner):
        self._owner = owner
        self._free: list[int] = []  # kept for checkpoint compat

    @property
    def _next(self):
        return int(self._owner.state.next_slot)

    @property
    def num_allocated(self) -> int:
        return self._next - int(self._owner.state.free_count) - len(self._free)

    def release(self, slots):
        """Push merge-freed slots onto the device free stack so spawn
        recycles them."""
        from vslam_tpu.tracking import fused

        slots = np.asarray([int(s) for s in np.asarray(slots) if s >= 0], np.int32)
        if len(slots) == 0:
            return
        pad = 256 * ((len(slots) + 255) // 256)
        padded = np.full(pad, -1, np.int32)
        padded[: len(slots)] = slots
        st = self._owner.state
        fl, fc = fused.push_free_slots(
            st.free_list, st.free_count, jnp.asarray(padded)
        )
        self._owner.state = st._replace(free_list=fl, free_count=fc)


class _ControllerView:
    def __init__(self, owner):
        self._owner = owner

    @property
    def threshold(self) -> float:
        return float(self._owner.state.threshold)

    @threshold.setter
    def threshold(self, v: float):
        self._owner.state = self._owner.state._replace(threshold=jnp.float32(v))


class FusedPoseTracker:
    """Per-frame odometry over the fused single-dispatch device program
    (tracking/fused.py) — same public surface as PoseTracker, ~1 host<->
    device round trip per frame instead of ~10.  This is the production
    tracker; PoseTracker remains the modular reference implementation."""

    def __init__(
        self,
        cam: cam_ops.CameraParams,
        config: ParameterCollection,
        landmark_capacity: int = 65536,
    ):
        from vslam_tpu.tracking import fused

        self.cam = cam
        self.cfg = config
        fp = config.framepoint_generation
        tr = config.tracking
        n_cells = (cam.rows // fp.bin_size_pixels) * (cam.cols // fp.bin_size_pixels)
        self.mode = (
            "depth" if config.command_line.tracker_mode == "RGB_DEPTH" else "stereo"
        )
        self.params = fused.FusedParams(
            capacity=fp.capacity,
            bin_size=fp.bin_size_pixels,
            border=fp.border_pixels,
            mode=self.mode,
            descriptor=fp.descriptor_type,
            detector=fp.detector_type,
            octaves=fp.detector_number_of_octaves,
            max_hamming_stereo=fp.maximum_matching_distance_triangulation,
            epipolar_tol=fp.maximum_epipolar_search_offset_pixels,
            min_disparity=fp.minimum_disparity_pixels,
            max_disparity=fp.maximum_disparity_pixels,
            min_depth=fp.minimum_depth_meters,
            max_depth=fp.maximum_depth_meters,
            min_track_for_landmark=tr.minimum_track_length_for_landmark_creation,
            min_inliers=tr.aligner_minimum_number_of_inliers,
            min_inlier_ratio=tr.aligner_minimum_inlier_ratio,
            enable_recovery=(
                config.command_line.option_recover_landmarks
                and tr.maximum_number_of_landmark_recoveries > 0
            ),
            radius_min=float(tr.minimum_threshold_distance_tracking_pixels),
            radius_max=float(tr.maximum_distance_tracking_pixels),
            radius_adaptive_max=float(
                max(
                    tr.maximum_threshold_distance_tracking_pixels,
                    tr.minimum_threshold_distance_tracking_pixels,
                )
            ),
            min_landmarks_to_track=tr.minimum_number_of_landmarks_to_track,
            min_delta_ang=tr.minimum_delta_angular_for_movement,
            min_delta_trans=tr.minimum_delta_translational_for_movement,
            gate_min=float(fp.matching_distance_tracking_threshold),
            good_tracking_ratio=tr.good_tracking_ratio,
            target_keypoints=min(int(n_cells * 0.7), int(fp.capacity * 0.7)),
            target_tolerance=fp.target_number_of_keypoints_tolerance,
            lm_min_forced_updates=config.landmark.minimum_number_of_forced_updates,
            lm_min_meas_for_opt=(
                config.landmark.minimum_number_of_measurements_for_optimization
            ),
            lm_max_t_err_depth_ratio=(
                config.landmark.maximum_translation_error_to_depth_ratio
            ),
            # Reference framepoint dropping (world_map.cpp:141-160,
            # slam_assembly.cpp:591-618): here the analogous map-lifecycle
            # mechanism is the in-graph eviction sweep of stale low-quality
            # unprotected landmark slots.
            enable_eviction=config.command_line.option_drop_framepoints,
            bilateral_depth=fp.enable_bilateral_filtering,
            # Result ring must cover the lagged-bundle span: each bundle
            # waits one extra chunk before its fetch (async-copy head
            # start), so unharvested frames span up to ~3 chunks.
            ring_size=max(64, 4 * int(config.parallelism.frames_per_chunk)),
            # On an accelerator the snapshot ring is an ARCHIVE (rows stay
            # live for the whole run): the relocalizer and BA/viz gather
            # descriptors/observations from it device-side instead of
            # shipping them to the host with every drain.  The CPU keeps a
            # small ring (tests; exact per-frame harvesting).
            kf_ring_size=(
                int(config.parallelism.kf_archive_size)
                if jax.default_backend() != "cpu"
                else 32
            ),
            threshold_min=fp.detector_threshold_minimum,
            threshold_max=fp.detector_threshold_maximum,
            threshold_max_change=fp.detector_threshold_maximum_change,
            kf_min_distance=config.world_map.minimum_distance_traveled_for_local_map,
            kf_min_radians=float(
                np.deg2rad(config.world_map.minimum_degrees_rotated_for_local_map)
            ),
            kf_min_frames=config.world_map.minimum_number_of_frames_for_local_map,
            kf_min_landmarks=config.local_map.minimum_number_of_landmarks,
            kf_max_landmarks=min(
                config.local_map.maximum_number_of_landmarks, fp.capacity
            ),
            split_frontend=tr.batch_frontend,
            gn_config=gn.GNConfig(
                max_iterations=tr.aligner_maximum_number_of_iterations,
                kernel_max_error=tr.aligner_maximum_error_kernel,
                damping=tr.aligner_damping,
                min_num_inliers=tr.aligner_minimum_number_of_inliers,
            ),
        )
        depth_calib = _depth_calibration(fp)
        # Per-frame builders serve the exact chunk_size==1 (CPU test)
        # path; the chunk builders roll a whole chunk's steps into ONE
        # dispatched program for the accelerator path (builders are lazy —
        # no tracing happens until first call).
        if self.params.split_frontend:
            self._frontend = fused.make_chunk_frontend(self.params, depth_calib)
            self._track_step = fused.make_track_step(self.params, depth_calib)
            self._step = None
            self._chunk_step = fused.make_chunk_step_split(
                self.params, depth_calib
            )
        else:
            self._step = fused.make_frame_step(self.params, depth_calib)
            self._chunk_step = fused.make_chunk_step(self.params, depth_calib)
        self.state = fused.init_state(
            cam, self.params, landmark_capacity,
            fp.detector_threshold_starting_value,
        )
        self.capacity = fp.capacity
        self.motion_model_on = tr.motion_model == "CONSTANT_VELOCITY"
        # CAMERA_ODOMETRY: external per-frame motion guesses (reference
        # -use-odometry, pose_tracker_3d.cpp:41-66).
        self.odometry_on = (
            tr.motion_model == "CAMERA_ODOMETRY"
            or config.command_line.option_use_odometry
        )
        self.trajectory: list[np.ndarray] = []
        self.stats = TrackerStats()
        self.allocator = _AllocatorView(self)
        self.controller = _ControllerView(self)
        self._dispatched = 0  # frames sent to the device
        self._harvested = 0  # frames read back from the ring
        # Pipelined-drain bookkeeping: a QUEUE of in-flight drain-bundle
        # outputs (device arrays of already-enqueued gather programs), each
        # with the frame count it covers and its keyframe-window start.
        # The async D2H copies started at dispatch give the fetch a head
        # start; an EXTRA chunk of lag (_bundle_lag=1) bought no measured
        # throughput on either the 128-frame bench or the 1024-frame scale
        # run and slightly worsened ATE via closure latency, so bundles
        # are fetched at the next drain point (lag 0).
        from collections import deque

        self._bundles = deque()
        self._bundle_lag = 0
        # On CPU (tests) transfers are ~free: ship/harvest every frame so
        # the engine sees exact per-frame poses.  On an accelerator, batch
        # both directions per chunk (see compute()): one dispatch and one
        # drain per chunk instead of per frame.
        on_cpu = jax.default_backend() == "cpu"
        chunk = max(int(config.parallelism.frames_per_chunk), 1)
        self.harvest_every = 1 if on_cpu else chunk
        self.chunk_size = 1 if on_cpu else chunk
        # Keyframe descriptors cross to the host ONLY when the sharded
        # descriptor-database path needs them there (parallel/
        # sharded_search.py inserts from host blocks); otherwise the
        # relocalizer gathers them device-side (fused.gather_kf_desc) and
        # the drain bundle ships a placeholder — the descriptor block is
        # the bundle's largest field.
        self._ship_desc = (
            config.parallelism.shard_descriptor_db and len(jax.devices()) > 1
        )
        # Observations ride the drain only where they are consumed every
        # keyframe (CPU exact-per-frame path, image-overlay dumps);
        # otherwise BA/viz fetch them lazily from the device archive.
        self._ship_uv4 = on_cpu or config.visualization.enable_image_dump
        self._buf: list[np.ndarray] = []
        self._odom_buf: list[np.ndarray] = []
        # Pre-staged device constants (avoids a tiny upload per step).
        self._idx = [jnp.int32(i) for i in range(self.chunk_size)]
        self._k_cache: dict[int, jnp.ndarray] = {}
        self._motion = jnp.asarray(self.motion_model_on)
        self._use_odom_false = jnp.asarray(False)
        self._odom_identity = jax.device_put(
            np.tile(np.eye(4, dtype=np.float32), (self.chunk_size, 1, 1))
        )
        self._last_pose = np.eye(4, dtype=np.float32)
        # Keyframe event queue: device snapshots harvested at drain time,
        # consumed by the engine via pop_keyframes().
        self._pending_keyframes: list[KeyframeSnapshot] = []
        # Engine-registered device arrays fetched WITH the next drain
        # bundle (closure query/ICP results — saves one round trip each).
        self._pending_extra = None
        self._fetched_extra = None
        self._kf_harvested = 0  # device kf_count already harvested
        # World-frame corrections applied while frames were in flight: rows
        # / snapshots computed before `cutoff` still carry the OLD world
        # frame and get C applied at harvest.  List of (cutoff_fidx, C).
        self._pending_corrections: list[tuple[int, np.ndarray]] = []
        self._last_status = LOCALIZING
        # Frame indices where registration failed (track re-rooted) — the
        # engine downweights pose-graph odometry edges spanning these
        # (reference breakTrack, world_map.cpp:260-279).
        self._break_frames: list[int] = []

    # -- state views -----------------------------------------------------
    @property
    def prev_frame(self):
        return self.state.prev

    @prev_frame.setter
    def prev_frame(self, f):
        if f is not None:
            self.state = self.state._replace(prev=f)

    @property
    def table(self):
        return self.state.table

    @table.setter
    def table(self, t):
        self.state = self.state._replace(table=t)

    @property
    def T_world_cam(self) -> np.ndarray:
        return np.asarray(self.state.T_world_cam, dtype=np.float32)

    @T_world_cam.setter
    def T_world_cam(self, T):
        self.state = self.state._replace(T_world_cam=jnp.asarray(T, jnp.float32))

    @property
    def last_motion(self) -> np.ndarray:
        return np.asarray(self.state.last_motion, dtype=np.float32)

    @last_motion.setter
    def last_motion(self, T):
        self.state = self.state._replace(last_motion=jnp.asarray(T, jnp.float32))

    @property
    def frame_idx(self) -> int:
        return int(self.state.frame_idx)

    @frame_idx.setter
    def frame_idx(self, v: int):
        # The harvest counters index the result ring by device frame_idx;
        # keep them in sync when it is reset (checkpoint resume).
        self.state = self.state._replace(frame_idx=jnp.int32(v))
        self._dispatched = int(v)
        self._harvested = int(v)
        self._bundles.clear()

    @property
    def status(self) -> str:
        """Localizing/Tracking state, harvested from the per-frame ring
        (reference Frame::Status, pose_tracker_3d.cpp:100-172)."""
        return self._last_status

    @status.setter
    def status(self, v):
        self._last_status = v

    @property
    def radius_px(self) -> float:
        return float(self.state.radius_px)

    @radius_px.setter
    def radius_px(self, v: float):
        self.state = self.state._replace(radius_px=jnp.float32(v))

    @property
    def desc_gate(self) -> float:
        return float(self.state.desc_gate)

    @desc_gate.setter
    def desc_gate(self, v: float):
        self.state = self.state._replace(desc_gate=jnp.float32(v))

    # --------------------------------------------------------------------
    def compute(
        self,
        img_l: np.ndarray,
        img_r: np.ndarray,
        odometry: np.ndarray | None = None,
    ) -> np.ndarray:
        """Process one frame.  Both directions of host<->device traffic are
        BATCHED, so that each transfer's fixed latency is paid once per
        chunk instead of once per frame:

          uploads   — frames buffer on host and ship as one (C, 2, H, W)
                      chunk (`chunk_size` frames), then C steps dispatch
                      against the device-resident chunk;
          readbacks — poses/stats accumulate in the device-side result
                      ring; one transfer every `harvest_every` frames
                      drains them all.

        The returned pose is therefore up to chunk_size + harvest_every
        frames behind; anything needing exact current state calls flush()
        first.  On CPU both knobs are 1 and behavior is exact per-frame.

        odometry: optional external motion guess T_cur_prev (4,4) for the
        CAMERA_ODOMETRY motion model."""
        t0 = time.perf_counter()
        if self.mode == "stereo":
            imgs = np.stack([img_l, img_r]).astype(np.uint8)
        else:
            imgs = np.stack([img_l, img_r]).astype(np.float32)
        self._buf.append(imgs)
        self._odom_buf.append(
            np.eye(4, dtype=np.float32) if odometry is None
            else np.asarray(odometry, np.float32)
        )
        if len(self._buf) >= self.chunk_size:
            self._dispatch_chunk()
        self._maybe_drain_lagged()
        self.stats.add_time("frame_step", time.perf_counter() - t0)
        return self._last_pose

    def _maybe_drain_lagged(self):
        """Pipelined drain: FETCH the bundle dispatched after the previous
        chunk (its gather program completed with that chunk, so this is a
        DMA that overlaps the current chunk's execution), then DISPATCH
        this chunk's bundle program for the next call to fetch.  Exact
        synchronous drain on the chunk_size==1 (CPU test) path."""
        if self.chunk_size == 1:
            if self._dispatched - self._harvested >= self.harvest_every:
                self._drain()
            return
        while len(self._bundles) > self._bundle_lag:
            b, upto, kf_start = self._bundles.popleft()
            self._drain(bundle=b, upto=upto, kf_window_start=kf_start)
        last = self._bundles[-1][1] if self._bundles else self._harvested
        if self._dispatched > last:
            self._dispatch_bundle()

    def _dispatch_bundle(self):
        """Enqueue the drain-bundle gather program for everything
        dispatched so far (runs on device right after the in-flight
        steps; fetched on a later call).

        The fetch stays SYNCHRONOUS at drain time, on the main thread; the
        per-drain round trip is amortized by chunk size and payload
        instead."""
        from vslam_tpu.tracking import fused

        KR = self.params.kf_ring_size
        kf_start = self._kf_harvested
        bundle = fused.drain_bundle(
            self.state, jnp.int32(kf_start % KR),
            ship_desc=self._ship_desc, ship_uv4=self._ship_uv4,
            quant_uv4=True,
        )
        self._bundles.append((bundle, self._dispatched, kf_start))
        # Start the D2H copies NOW, in the background: the transfer then
        # rides the next chunk's execution window and the blocking fetch
        # at the next drain finds the bytes already on host.
        self._start_async_fetch(bundle)

    @staticmethod
    def _start_async_fetch(tree) -> None:
        try:
            for leaf in jax.tree_util.tree_leaves(tree):
                if hasattr(leaf, "copy_to_host_async"):
                    leaf.copy_to_host_async()
        except Exception:  # backends without async D2H: fetch stays sync
            pass

    def _dispatch_chunk(self):
        """Upload the buffered frames as one chunk; dispatch their steps."""
        k = len(self._buf)
        if k == 0:
            return
        C = self.chunk_size
        chunk = np.zeros((C,) + self._buf[0].shape, self._buf[0].dtype)
        for i, f in enumerate(self._buf):
            chunk[i] = f
        if self.odometry_on:
            odom = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
            odom[:k] = np.stack(self._odom_buf)
            odom_dev = jax.device_put(odom)
        else:
            odom_dev = self._odom_identity
        self._buf.clear()
        self._odom_buf.clear()
        self._dispatch_staged((jax.device_put(chunk), k, odom_dev))

    def _dispatch_staged(self, staged):
        dev, k, odom_dev = (staged if len(staged) == 3
                            else (staged[0], staged[1], self._odom_identity))
        use_odom = (
            jnp.asarray(True) if self.odometry_on else self._use_odom_false
        )
        if self.chunk_size > 1:
            # ONE dispatch covers the whole chunk (fused fori_loop over
            # the per-frame steps — VERDICT r4 #1b); k is a traced scalar
            # so tail chunks reuse the same compiled program.
            self.state = self._chunk_step(
                self.cam, self.state, dev, self._k_dev(k), self._motion,
                odom_dev, use_odom,
            )
            self._dispatched += k
            return
        if self.params.split_frontend:
            # Split pipeline: ONE batched front-end dispatch for the chunk,
            # then k sequential track steps consuming precomputed frames.
            frames_b, n_kp_b, n_fp_b, planes_b = self._frontend(
                self.cam, self.state.threshold, dev
            )
            for i in range(k):
                self.state, _ = self._track_step(
                    self.cam, self.state, frames_b, n_kp_b, n_fp_b,
                    planes_b, dev, self._idx[i], self._motion,
                    odom_dev, use_odom,
                )
            self._dispatched += k
            return
        for i in range(k):  # padded rows are never dispatched
            self.state, _ = self._step(
                self.cam, self.state, dev, self._idx[i], self._motion,
                odom_dev, use_odom,
            )
        self._dispatched += k

    def _k_dev(self, k: int):
        """Staged device scalar for the chunk-step frame count."""
        h = self._k_cache.get(k)
        if h is None:
            h = self._k_cache[k] = jnp.int32(k)
        return h

    # -- prefetch path ---------------------------------------------------
    def prestage(self, frame_pairs) -> list:
        """Upload frames ahead of the compute loop in chunk_size groups.

        Returns opaque handles for compute_prestaged().  This is the data
        path for dataset playback: the IO pipeline (native prefetcher)
        decodes and ships frames to the device while earlier frames
        compute, so the odometry loop never waits on the transfer link."""
        handles = []
        C = self.chunk_size
        dtype = np.uint8 if self.mode == "stereo" else np.float32
        for i in range(0, len(frame_pairs), C):
            group = frame_pairs[i : i + C]
            chunk = np.zeros((C, 2) + group[0][0].shape, dtype)
            for j, (l, r) in enumerate(group):
                chunk[j] = np.stack([l, r]).astype(dtype)
            handles.append((jax.device_put(chunk), len(group)))
        jax.block_until_ready([h[0] for h in handles])
        return handles

    def compute_prestaged(self, staged) -> np.ndarray:
        """Dispatch one prestaged chunk (see prestage()).

        The drain LAGS one chunk behind the dispatch: chunk N's results are
        read back from the state snapshot taken after N's steps, AFTER
        chunk N+1 has been dispatched — so the device executes N+1 while
        the host waits on N's transfer and runs the keyframe/closure path.
        Without the lag every drain idles the device for the full
        readback + host work."""
        t0 = time.perf_counter()
        self._dispatch_chunk()  # preserve frame order w.r.t. buffered path
        self._dispatch_staged(staged)
        self._maybe_drain_lagged()
        self.stats.add_time("frame_step", time.perf_counter() - t0)
        return self._last_pose

    def set_pending_extra(self, extra) -> None:
        """Register a device pytree to fetch together with the next drain
        bundle (engine closure pipeline; None clears)."""
        self._pending_extra = extra
        if extra is not None:
            self._start_async_fetch(extra)

    def take_fetched_extra(self):
        """Return (and clear) the extra pytree fetched by the last drain,
        or None if the last drain carried none."""
        out = self._fetched_extra
        self._fetched_extra = None
        return out

    def _corrected(self, T: np.ndarray, fidx: int) -> np.ndarray:
        """Apply world-frame corrections that landed while frame `fidx` was
        in flight (its device result was computed pre-correction)."""
        for cutoff, C in self._pending_corrections:
            if fidx < cutoff:
                T = C @ T
        return T.astype(np.float32)

    def _drain(self, bundle=None, upto: int | None = None,
               kf_window_start: int | None = None):
        """One device->host transfer harvesting the un-read ring rows AND
        a speculative window of keyframe snapshots (fused.drain_bundle —
        one device round trip instead of two when keyframes happened).

        bundle/upto: fetch a bundle whose gather program was dispatched
        earlier (_dispatch_bundle), covering frames [_harvested, upto) —
        the transfer then overlaps the execution of newer dispatched
        steps.  With bundle=None a fresh bundle over everything dispatched
        is made and fetched synchronously (flush / CPU path)."""
        from vslam_tpu.tracking import fused
        from vslam_tpu.utils import log as _log

        if bundle is None:
            KR = self.params.kf_ring_size
            kf_window_start = self._kf_harvested
            bundle = fused.drain_bundle(
                self.state, jnp.int32(kf_window_start % KR),
                ship_desc=self._ship_desc, ship_uv4=self._ship_uv4,
                quant_uv4=True,
            )
            upto = self._dispatched
        # One blocking transfer carries the bundle AND the engine's armed
        # extras (closure query/ICP results) — a single round trip.
        with _log.measure("drain_fetch"):
            if self._pending_extra is not None:
                data, self._fetched_extra = jax.device_get(
                    (bundle, self._pending_extra)
                )
                self._pending_extra = None
            else:
                data = jax.device_get(bundle)
        if upto == self._harvested:
            return
        assert upto - self._harvested <= self.params.ring_size
        ring = np.asarray(data[0])
        self._kf_bundle = data[1:]
        self._kf_bundle_start = kf_window_start
        _t_parse = time.perf_counter()
        s = self.stats
        kf_total = self._kf_harvested
        for fi in range(self._harvested, upto):
            row = ring[fi % self.params.ring_size]
            T = self._corrected(row[:16].reshape(4, 4), fi)
            self.trajectory.append(T)
            self._last_pose = T
            n_fp = int(row[fused._R_NFP])
            n_matches = int(row[fused._R_NMATCH])
            s.n_frames += 1
            s.n_keypoints += int(row[fused._R_NKP])
            s.n_framepoints += n_fp
            s.n_tracked_points += n_matches
            s.n_inliers += int(row[fused._R_NINL])
            s.n_recovered += int(row[fused._R_NRECOVER])
            s.n_spawned += int(row[fused._R_NSPAWN])
            s.tracking_ratio = n_matches / max(n_fp, 1)
            if row[fused._R_OK] == 0.0:
                s.n_breaks += 1
                self._break_frames.append(fi)
            self._last_status = (
                TRACKING if row[fused._R_STATUS] > 0.0 else LOCALIZING
            )
            kf_total = int(row[fused._R_KFCOUNT])
        _log.chronometers.add("drain_parse", time.perf_counter() - _t_parse)
        if kf_total > self._kf_harvested:
            with _log.measure("drain_harvest_kf"):
                self._harvest_keyframes(kf_total)
        self._kf_bundle = None  # tied to this drain's kf_start
        self._harvested = upto
        # Corrections older than everything still unharvested are spent.
        self._pending_corrections = [
            (c, C) for (c, C) in self._pending_corrections if c > self._harvested
        ]

    def _harvest_keyframes(self, kf_total: int):
        """Pull new keyframe snapshots from the device ring (only runs when
        the result ring says new keyframes exist — typically one extra
        transfer every few drains).

        Only the NEW rows travel: a bucketed device-side gather compacts
        them first (the full rings are ~2 MB, most of it already
        harvested)."""
        from vslam_tpu.tracking import fused

        start = self._kf_harvested
        KR = self.params.kf_ring_size
        n_new = kf_total - start
        assert n_new <= KR, (
            f"keyframe ring overflow: {n_new} keyframes since last "
            f"drain > ring size {KR}"
        )
        ws = getattr(self, "_kf_bundle_start", None)
        if ws is None:
            ws = start
        if (
            getattr(self, "_kf_bundle", None)
            and kf_total - ws <= fused.KF_WINDOW
        ):
            # Fast path: the snapshots came along with the ring readback
            # (bundle rows begin at its window start ws <= start).
            base = ws
            pose, fidxs, ns, slots, xyz, desc, uv4 = self._kf_bundle
        else:
            bucket = 1 << max(int(np.ceil(np.log2(max(n_new, 1)))), 2)
            base = start
            rows = np.zeros(bucket, np.int32)
            rows[:n_new] = [k % KR for k in range(start, kf_total)]
            st = self.state
            pose, fidxs, ns, slots, xyz, desc, uv4 = jax.device_get(
                fused.gather_kf_rows(
                    st.kf_pose, st.kf_frame_idx, st.kf_n, st.kf_slots,
                    st.kf_xyz, st.kf_desc, st.kf_uv4, jnp.asarray(rows),
                    ship_desc=self._ship_desc, ship_uv4=self._ship_uv4,
                    quant_uv4=True,
                )
            )
        for k in range(start, kf_total):
            r = k - base
            n = int(ns[r])
            fidx = int(fidxs[r])
            C = np.eye(4, dtype=np.float32)
            for cutoff, Cp in self._pending_corrections:
                if fidx < cutoff:
                    C = Cp @ C
            T_kf = (C @ pose[r]).astype(np.float32)
            xyz_k = (
                np.asarray(xyz[r][:n]) @ C[:3, :3].T + C[:3, 3]
            ).astype(np.float32)
            if self._ship_uv4:
                uv4_k = np.asarray(uv4[r][:n])
                if uv4_k.dtype == np.uint16:  # 1/16-px transfer encoding
                    uv4_k = uv4_k.astype(np.float32) / fused.UV4_SCALE
            else:
                uv4_k = None  # device-resident: BA/viz gather lazily
            self._pending_keyframes.append(
                KeyframeSnapshot(
                    map_id=k,
                    frame_idx=fidx,
                    T_world_kf=T_kf,
                    slots=np.asarray(slots[r][:n]),
                    xyz_w=xyz_k,
                    desc=(np.asarray(desc[r][:n]) if self._ship_desc
                          else None),
                    uv4=uv4_k,
                    ring_row=k % KR,
                )
            )
        self._kf_harvested = kf_total

    def pop_keyframes(self) -> list[KeyframeSnapshot]:
        """Harvested-but-unconsumed keyframe events (engine API)."""
        out = self._pending_keyframes
        self._pending_keyframes = []
        return out

    def apply_world_correction(self, C: np.ndarray):
        """Left-multiply a rigid world-frame correction onto the live device
        pose state (pose-graph back-propagation of the most recent
        segment).  Landmark corrections are applied separately per origin
        local map via lm_mod.apply_kf_corrections."""
        C = np.asarray(C, np.float32)
        Cj = jnp.asarray(C)
        self.state = self.state._replace(
            T_world_cam=(Cj @ self.state.T_world_cam).astype(jnp.float32),
            T_last_kf=(Cj @ self.state.T_last_kf).astype(jnp.float32),
        )
        self._pending_corrections.append((self._dispatched, C))

    def flush(self):
        """Dispatch any buffered frames and drain the batched readback
        (call before reading final state)."""
        self._dispatch_chunk()
        while self._bundles:
            b, upto, kf_start = self._bundles.popleft()
            self._drain(bundle=b, upto=upto, kf_window_start=kf_start)
        self._drain()
