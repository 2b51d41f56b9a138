"""Windowed full bundle adjustment inside the live SLAM loop.

The reference's full-BA mode (GraphOptimizer::addPoseWithFactors +
optimizeFactorGraph, src/map_optimization/graph_optimizer.cpp:319-409,
459-488) re-optimizes recent keyframe poses AND landmark positions every
`number_of_frames_per_bundle_adjustment` frames, then back-propagates both.
Here the factor graph is assembled from the keyframe snapshots the fused
tracker already harvests (each LocalMap carries the stereo observation
[uL,vL,uR,vR] of every snapshotted landmark — exactly one BA measurement
row), solved by the Schur-complement solver (backend/ba.py), sharded over
the device mesh when more than one device is available
(parallel/sharded_ba.py), and scattered back into the landmark table and
the keyframe/trajectory bookkeeping.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from vslam_tpu.backend import ba as ba_mod
from vslam_tpu.mapping import landmarks as lm_mod

# Static problem shape (compiled once): the optimization window covers the
# last WINDOW keyframes; each landmark contributes up to OMAX observations
# (its MOST RECENT ones — a long-lived landmark keeps a ring of its last
# OMAX keyframe observations instead of silently truncating to the first
# few, cf. reference optimizeFactorGraph which keeps every measurement,
# graph_optimizer.cpp:319-409).
WINDOW = 16
OMAX = 16
MIN_OBS = 2  # landmarks observed once constrain nothing jointly


def _fetch_archived_uv4(engine, maps) -> None:
    """Populate m.uv4 for window maps whose observations live in the
    device-side keyframe archive (slim-drain mode ships no uv4 per drain;
    BA fetches its window's blocks here, ONCE per map, cached on the
    LocalMap).  One bucketed gather + one transfer per BA call."""
    tracker = engine.tracker
    state = getattr(tracker, "state", None)
    need = [m for m in maps if m.uv4 is None and m.ring_row >= 0]
    if state is None or not need:
        return
    from vslam_tpu.tracking import fused

    KR = state.kf_uv4.shape[0]
    # Archive rows wrap after KR keyframes; anything older is gone (the
    # window is recent, so this only trips on misconfigured tiny rings).
    live = [m for m in need if m.map_id > tracker._kf_harvested - KR]
    if not live:
        return
    bucket = 1 << max(len(live) - 1, 0).bit_length()
    rows = np.zeros(bucket, np.int32)
    rows[: len(live)] = [m.ring_row for m in live]
    fetched = np.asarray(
        jax.device_get(fused.gather_kf_uv4(state.kf_uv4, jnp.asarray(rows)))
    )
    for i, m in enumerate(live):
        n = len(m.landmark_slots)
        m.uv4 = fetched[i, :n].astype(np.float32) / fused.UV4_SCALE


def build_window_problem(engine, window: int = WINDOW, omax: int = OMAX):
    """Assemble a BAProblem over the last `window` keyframes.

    Returns (problem, kf_ids (P,) global keyframe ids, slot_arr (L,) table
    slots, L_real) or None if the window holds too few observations.
    """
    maps = engine.world_map.local_maps[-window:]
    _fetch_archived_uv4(engine, maps)
    maps = [m for m in maps if m.uv4 is not None]
    if len(maps) < 2:
        return None
    kf_ids = [m.map_id for m in maps]
    P = window

    table = engine.tracker.table
    xyz_all = np.asarray(table.xyz_w)
    nup_all = np.asarray(table.n_updates)

    # Group observations by landmark slot — DROPPING stale rows first: a
    # slot recycled by the eviction sweep (or re-targeted by a merge)
    # between snapshot time and now pairs an old measurement with a
    # different physical landmark; feeding those to BA actively corrupts
    # the window (r4 diagnosis: ~8% of rows with reprojection chi2 > 1e3,
    # all in the oldest snapshots — BA diverged and open-loop ATE got
    # WORSE with BA on).  The snapshot's own keyframe-frame landmark
    # position (xyz_kf) is the consistency witness: the CURRENT table
    # position projected into the keyframe must still agree with it.
    cam_col, slot_col, uv4_col = [], [], []
    for local_cam, m in enumerate(maps):
        slots_m = np.asarray(m.landmark_slots)
        sel = slots_m >= 0
        if not sel.any():
            continue
        R = m.T_world_kf[:3, :3]
        t = m.T_world_kf[:3, 3]
        p_now = (xyz_all[slots_m[sel]] - t) @ R  # inv(T_kf) @ xyz_w
        p_snap = np.asarray(m.xyz_kf)[sel]
        d = np.linalg.norm(p_now - p_snap, axis=1)
        tol = np.maximum(0.2, 0.02 * np.linalg.norm(p_snap, axis=1))
        rows = np.flatnonzero(sel)[d < tol]
        if len(rows):
            cam_col.append(np.full(len(rows), local_cam, np.int32))
            slot_col.append(slots_m[rows])
            uv4_col.append(np.asarray(m.uv4)[rows])
    if not cam_col:
        return None
    all_cam = np.concatenate(cam_col)
    all_slot = np.concatenate(slot_col)
    all_uv4 = np.concatenate(uv4_col).astype(np.float32)

    # Vectorized group-by-slot (the per-row Python dict loop cost ~100s of
    # ms per BA call at production sizes): stable-sort by slot, cumcount
    # within group, keep the LAST omax observations of each slot.
    uniq, inv, counts = np.unique(all_slot, return_inverse=True,
                                  return_counts=True)
    order = np.argsort(inv, kind="stable")
    inv_s = inv[order]
    starts = np.r_[0, np.cumsum(counts)[:-1]]
    cum = np.arange(len(inv_s)) - starts[inv_s]  # position within group
    from_end = counts[inv_s] - 1 - cum
    keep = from_end < omax
    oi = np.minimum(counts[inv_s], omax) - 1 - from_end  # slot column
    eligible = counts >= MIN_OBS
    keep &= eligible[inv_s]
    lm_ids = np.cumsum(eligible) - 1  # dense landmark index per uniq slot
    slots = uniq[eligible]
    if len(slots) < 16:
        return None

    # Accelerator bucket floor 2048: each landmark-bucket size is one more
    # compiled program, and one big bucket covers the production window
    # (16 kf x 512 snapshot rows) with the padded rows as masked vmap
    # lanes.  CPU (the test harness) keeps tight buckets — the padding
    # would be real scalar work there.  Re-tuning the floor for the GPU
    # is open work (ROADMAP A5).
    floor = 6 if jax.default_backend() == "cpu" else 11

    def pow2(x):
        return 1 << max(int(np.ceil(np.log2(max(x, 1)))), floor)

    L = pow2(len(slots))
    slot_arr = np.zeros(L, np.int32)
    slot_arr[: len(slots)] = slots
    xyz = np.zeros((L, 3), np.float32)
    xyz[: len(slots)] = xyz_all[slots]
    obs_cam = np.zeros((L, omax), np.int32)
    obs_uv4 = np.zeros((L, omax, 4), np.float32)
    obs_w = np.zeros((L, omax), np.float32)
    obs_mask = np.zeros((L, omax), bool)
    lm_valid = np.zeros(L, bool)
    lm_valid[: len(slots)] = True
    rows_kept = order[keep]
    li_kept = lm_ids[inv_s[keep]]
    oi_kept = oi[keep]
    obs_cam[li_kept, oi_kept] = all_cam[rows_kept]
    obs_uv4[li_kept, oi_kept] = all_uv4[rows_kept]
    obs_w[li_kept, oi_kept] = 1.0 + np.log1p(
        nup_all[all_slot[rows_kept]].astype(np.float64)
    ).astype(np.float32)
    obs_mask[li_kept, oi_kept] = True

    T_wc = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    cam_fixed = np.ones(P, bool)  # padding cameras frozen
    for ci, m in enumerate(maps):
        T_wc[ci] = m.T_world_kf
        cam_fixed[ci] = False
    cam_fixed[0] = True  # gauge: anchor the oldest keyframe in the window

    # Pose-pose factors between consecutive window keyframes (reference
    # addPoseWithFactors pose edges + _setPoseEdge information,
    # graph_optimizer.cpp:319-409, 490-526).  The measurement is the
    # CURRENT relative pose estimate — exactly like the reference, whose
    # edges are measured from the vertex estimates at insertion time and
    # whose factor graph is cleared after every optimizeFactorGraph: the
    # prior regularizes BA toward the present (closure-corrected)
    # trajectory.  Using RAW odometry here instead re-fights the pose
    # graph inside every window and wrecked the scale run (r4: ATE 0.36 m
    # -> 13.7 m before this was caught).
    gopt = engine.cfg.graph_optimization
    info_rot = gopt.base_information_frame
    info_trans = (
        info_rot / gopt.base_information_frame_factor_for_translation
        if gopt.free_translation_for_poses
        else info_rot
    )
    odo_T = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    odo_w = np.zeros(P, np.float32)
    for ci in range(len(maps) - 1):
        a, b = kf_ids[ci], kf_ids[ci + 1]
        odo_T[ci] = (
            np.linalg.inv(engine.kf_poses[a]) @ engine.kf_poses[b]
        ).astype(np.float32)
        ws = np.asarray(engine.kf_odom_weight[a:b], np.float32)
        odo_w[ci] = 1.0 / float(np.sum(1.0 / np.maximum(ws, 1e-9)))

    prob = ba_mod.BAProblem(
        T_wc=jnp.asarray(T_wc),
        xyz=jnp.asarray(xyz),
        obs_cam=jnp.asarray(obs_cam),
        obs_uv4=jnp.asarray(obs_uv4),
        obs_weight=jnp.asarray(obs_w),
        obs_mask=jnp.asarray(obs_mask),
        lm_valid=jnp.asarray(lm_valid),
        cam_fixed=jnp.asarray(cam_fixed),
        odo_T=jnp.asarray(odo_T),
        odo_weight=jnp.asarray(odo_w),
        odo_info=jnp.asarray(
            [info_trans] * 3 + [info_rot] * 3, dtype=jnp.float32
        ),
    )
    return prob, kf_ids, slot_arr, len(slots)


def warm_windowed_ba(engine):
    """Pre-compile the windowed-BA solve at its production bucket (L=2048,
    P=WINDOW) with the exact BAConfig the engine will use, so the first
    in-loop BA pays no compile."""
    gopt = engine.cfg.graph_optimization
    if not gopt.enable_full_bundle_adjustment:
        return
    if jax.default_backend() == "cpu":
        return  # CPU (test harness) uses tight per-problem buckets
    L = 2048
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-5, 5, (L, 3)).astype(np.float32)
    xyz[:, 2] += 10.0
    prob = ba_mod.BAProblem(
        T_wc=jnp.asarray(np.tile(np.eye(4, dtype=np.float32), (WINDOW, 1, 1))),
        xyz=jnp.asarray(xyz),
        obs_cam=jnp.zeros((L, OMAX), jnp.int32),
        obs_uv4=jnp.zeros((L, OMAX, 4), jnp.float32),
        obs_weight=jnp.ones((L, OMAX), jnp.float32),
        obs_mask=jnp.asarray(np.arange(OMAX)[None, :] < 2).repeat(L, axis=0),
        lm_valid=jnp.ones(L, bool),
        cam_fixed=jnp.asarray(np.arange(WINDOW) == 0),
        odo_T=jnp.asarray(np.tile(np.eye(4, dtype=np.float32), (WINDOW, 1, 1))),
        odo_weight=jnp.ones(WINDOW, jnp.float32),
        odo_info=jnp.ones(6, jnp.float32),
    )
    config = ba_mod.BAConfig(
        iterations=gopt.maximum_number_of_iterations,
        robust_chi2=(
            engine.cfg.tracking.aligner_maximum_error_kernel
            if gopt.enable_robust_kernel_for_landmarks
            else 1e12
        ),
    )
    n_dev = len(jax.devices())
    if n_dev > 1 and engine.cfg.parallelism.shard_landmarks:
        from vslam_tpu.parallel import mesh as mesh_mod
        from vslam_tpu.parallel import sharded_ba

        sharded_ba.bundle_adjust_sharded(
            engine.cam, prob, mesh_mod.make_mesh(), config
        )
    else:
        ba_mod.bundle_adjust(engine.cam, prob, config)


def run_windowed_ba(
    engine,
    iterations: int | None = None,
    write_landmarks: bool = True,
    write_poses: bool = True,
    update_live: bool = True,
) -> np.ndarray | None:
    """Build + solve the windowed BA problem and back-propagate.

    The write_* switches exist for ablation (which write-back component
    helps/hurts); production uses all three.

    Returns the correction applied to the newest keyframe (and the live
    pose), or None if no BA ran.
    """
    built = build_window_problem(engine)
    if built is None:
        return None
    prob, kf_ids, slot_arr, n_lm = built
    config = ba_mod.BAConfig(
        iterations=iterations
        or engine.cfg.graph_optimization.maximum_number_of_iterations,
        # enable_robust_kernel_for_landmarks (reference _setPointEdge
        # Cauchy kernel gate, graph_optimizer.cpp:524): disabled = no
        # reweighting (threshold effectively infinite).
        robust_chi2=(
            engine.cfg.tracking.aligner_maximum_error_kernel
            if engine.cfg.graph_optimization.enable_robust_kernel_for_landmarks
            else 1e12
        ),
    )

    n_dev = len(jax.devices())
    if n_dev > 1 and engine.cfg.parallelism.shard_landmarks:
        from vslam_tpu.parallel import mesh as mesh_mod
        from vslam_tpu.parallel import sharded_ba

        mesh = mesh_mod.make_mesh()
        # L is a power of two >= 64, so it divides across any 2^k mesh.
        T_opt, xyz_opt, _ = sharded_ba.bundle_adjust_sharded(
            engine.cam, prob, mesh, config
        )
    else:
        T_opt, xyz_opt, _ = ba_mod.bundle_adjust(engine.cam, prob, config)
    T_opt = np.asarray(T_opt)
    xyz_opt = np.asarray(xyz_opt)
    if not (np.all(np.isfinite(T_opt)) and np.all(np.isfinite(xyz_opt))):
        return None

    tracker = engine.tracker

    # Landmark write-back (graph_optimizer.cpp:478-486).
    if write_landmarks:
        use = np.zeros(len(slot_arr), bool)
        use[:n_lm] = True
        tracker.table = lm_mod.scatter_xyz(
            tracker.table,
            jnp.asarray(slot_arr),
            jnp.asarray(xyz_opt),
            jnp.asarray(use),
        )
    if not write_poses:
        return np.eye(4, dtype=np.float32)

    # Pose write-back: per-keyframe corrections inside the window propagate
    # to the stored trajectory segments; the newest keyframe's correction
    # also moves the live pose.  Delta gate (reference
    # minimum_estimation_delta_for_update_meters,
    # graph_optimizer.cpp:430-450): corrections at the tracking-noise
    # level are jitter, not information — writing them back adds variance
    # to an otherwise smooth trajectory (r4 ablation: ungated pose
    # write-back DOUBLED open-loop ATE), so sub-gate keyframes keep their
    # tracker pose.
    gate = engine.cfg.graph_optimization.minimum_estimation_delta_for_update_meters
    corrections = {}
    for ci, k in enumerate(kf_ids):
        C = (T_opt[ci] @ np.linalg.inv(engine.kf_poses[k])).astype(np.float32)
        # Full matrix-difference norm, as the reference gates on
        # (graph_optimizer.cpp:433): a rotation-only correction above
        # threshold must not be discarded (ADVICE r4).
        if np.linalg.norm(C - np.eye(4, dtype=np.float32)) < gate:
            continue
        corrections[k] = C
        engine.kf_poses[k] = T_opt[ci].astype(np.float32).copy()
        engine.world_map.local_maps[k].T_world_kf = engine.kf_poses[k].copy()
    if not corrections:
        return np.eye(4, dtype=np.float32)

    traj = tracker.trajectory
    if traj:
        kf_frames = np.asarray(engine.kf_frame_indices)
        f_idx = np.arange(len(traj))
        owner = np.clip(
            np.searchsorted(kf_frames, f_idx, side="left"),
            0,
            len(engine.kf_frame_indices) - 1,
        )
        stacked = np.stack(traj).astype(np.float32)
        for k, C in corrections.items():
            sel = owner == k
            if sel.any():
                stacked[sel] = np.einsum("ij,fjk->fik", C, stacked[sel])
        tracker.trajectory = [stacked[f] for f in range(len(traj))]

    C_last = corrections.get(kf_ids[-1], np.eye(4, dtype=np.float32))
    if update_live:
        if hasattr(tracker, "apply_world_correction"):
            tracker.apply_world_correction(C_last)
        else:
            tracker.T_world_cam = (
                C_last @ tracker.T_world_cam
            ).astype(np.float32)
        if engine.world_map._last_T is not None:
            engine.world_map._last_T = (
                C_last @ engine.world_map._last_T
            ).astype(np.float32)
    return C_last
