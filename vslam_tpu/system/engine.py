"""SlamEngine: full-system orchestration.

The array-program SLAMAssembly (reference src/system/slam_assembly.cpp):
wires the pose tracker, world map (keyframe/local-map creation), the
Hamming-database relocalizer, landmark merging, and the pose-graph /
bundle-adjustment back-end; owns the per-frame `process` loop, trajectory
output and the end-of-run performance report (printReport parity,
slam_assembly.cpp:622-744).

Pipelining design: with the fused tracker, the keyframe trigger and the
keyframe snapshot run INSIDE the per-frame device program
(tracking/fused.py) and arrive as events in the batched ring readback —
`process` never drains the device pipeline.  Keyframe work (local-map
creation, loop-closure detection, pose-graph optimization, landmark
merging) therefore lags the tracker by up to chunk+harvest frames; rigid
corrections are back-propagated to everything already produced, and frames
that were in flight across a correction get it applied at harvest
(tracker._pending_corrections).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from vslam_tpu.backend import pose_graph as pg
from vslam_tpu.io.config import ParameterCollection
from vslam_tpu.loop.relocalizer import Relocalizer
from vslam_tpu.mapping import landmarks as lm_mod
from vslam_tpu.mapping import merging
from vslam_tpu.mapping.local_maps import WorldMap
from vslam_tpu.ops import camera as cam_ops
from vslam_tpu.utils import log
from vslam_tpu.tracking.tracker import (
    FusedPoseTracker,
    KeyframeSnapshot,
    PoseTracker,
)

@jax.jit
def _remap_slots_device(slots, lut):
    """Follow a landmark-slot remap LUT on device (-1 passes through)."""
    return jnp.where(slots >= 0, lut[jnp.maximum(slots, 0)], slots)


# Odometry edges spanning a tracking break carry ~no information: the
# motion across the break is dead-reckoned (reference breakTrack re-roots
# the map instead, world_map.cpp:260-279; a later closure reattaches it =
# setTrack, :281-303 — here the pose graph does the reattaching, so the
# broken edge must not fight the closure).
BREAK_EDGE_WEIGHT = 1e-3


class SlamEngine:
    def __init__(
        self,
        cam: cam_ops.CameraParams,
        config: ParameterCollection | None = None,
        landmark_capacity: int = 65536,
    ):
        self.cfg = config or ParameterCollection()
        # Reject inconsistent parameters up front (reference
        # validateParameters, parameters.cpp:443-454).
        self.cfg.validate()
        self.cam = cam
        tracker_cls = (
            FusedPoseTracker if self.cfg.tracking.use_fused_tracker else PoseTracker
        )
        self.tracker = tracker_cls(cam, self.cfg, landmark_capacity)
        wm = self.cfg.world_map
        self.world_map = WorldMap(
            min_distance=wm.minimum_distance_traveled_for_local_map,
            min_degrees=wm.minimum_degrees_rotated_for_local_map,
            min_frames=wm.minimum_number_of_frames_for_local_map,
        )
        # Device mesh (ParallelismParameters): with >1 device the
        # loop-closure search runs row-sharded and windowed BA shards its
        # landmark blocks (parallel/ layer).
        self.mesh = None
        import jax

        if len(jax.devices()) > 1 and (
            self.cfg.parallelism.shard_descriptor_db
            or self.cfg.parallelism.shard_landmarks
        ):
            from vslam_tpu.parallel import mesh as mesh_mod

            # ParallelismParameters mesh layout: (1,) means "use every
            # visible device on the configured axis"; an explicit shape
            # caps the device count (e.g. mesh_shape: [4]).
            par = self.cfg.parallelism
            n_mesh = int(np.prod(par.mesh_shape))
            self.mesh = mesh_mod.make_mesh(
                n_devices=None if n_mesh <= 1 else n_mesh,
                axis_name=(
                    par.mesh_axis_names[-1] if par.mesh_axis_names else "lm"
                ),
            )
        reloc_mesh = (
            self.mesh if self.cfg.parallelism.shard_descriptor_db else None
        )
        self.relocalizer = Relocalizer(self.cfg.relocalization, mesh=reloc_mesh)
        if hasattr(self.tracker, "state"):
            # Device keyframe-archive accessor: closure ICP gathers its
            # point sets on device from the snapshot archive (horizon =
            # oldest map id whose row may have been overwritten).
            _tr = self.tracker

            def _ring_provider():
                st = _tr.state
                return (
                    st.kf_pose, st.kf_xyz,
                    _tr._kf_harvested - st.kf_pose.shape[0],
                )

            self.relocalizer.ring_provider = _ring_provider
        self.open_loop = self.cfg.command_line.option_disable_relocalization
        # Pose-graph bookkeeping: one vertex per local map keyframe.
        self.kf_poses: list[np.ndarray] = []
        self.kf_frame_indices: list[int] = []
        self.kf_odometry: list[np.ndarray] = []  # T_{k-1,k} measured
        self.kf_odom_weight: list[float] = []  # breakTrack-aware edge weights
        self.closure_edges: list[tuple[int, int, np.ndarray]] = []
        self._breaks_consumed = 0
        # Deferred closure pipeline (fused tracker): queries and ICP
        # verifications dispatched at drain N are fetched at drain N+1 in
        # one batched device_get — no per-stage round trips.
        self._inflight_queries: list = []
        self._inflight_icp: list = []
        self._slot_remap: dict[int, int] = {}  # absorbed -> representative
        self._last_ba_frame = 0
        # Per-keyframe image dump (reference ImageViewer parity as files,
        # image_viewer.cpp:84-155): keep a bounded ring of recent left
        # images so keyframe events (which lag the tracker by up to one
        # drain) can still render their overlay.
        self._viz_enabled = self.cfg.visualization.enable_image_dump
        self._viz_dir = self.cfg.visualization.dump_directory
        self._viz_ring: dict[int, np.ndarray] = {}
        if self._viz_enabled:
            import os

            os.makedirs(self._viz_dir, exist_ok=True)
        self.n_optimizations = 0
        self.n_merges = 0
        self.n_ba_runs = 0
        self._t_start = time.perf_counter()
        self._frame_times: list[float] = []

    # ------------------------------------------------------------------
    def process(
        self,
        img_l: np.ndarray,
        img_r: np.ndarray,
        odometry: np.ndarray | None = None,
    ) -> np.ndarray:
        """Process one stereo frame; returns current T_world_cam.

        With the fused tracker the returned pose may lag by up to
        chunk+harvest frames (exact on CPU); keyframe/closure work happens
        on harvested snapshot events without stalling the device pipeline.
        odometry: optional external motion guess (CAMERA_ODOMETRY model).
        """
        t0 = time.perf_counter()
        if self._viz_enabled:
            idx = self.tracker.frame_idx
            self._viz_ring[idx] = img_l
            for stale in [k for k in self._viz_ring if k < idx - 128]:
                del self._viz_ring[stale]
        T = self.tracker.compute(img_l, img_r, odometry)
        if hasattr(self.tracker, "pop_keyframes"):
            self._consume_keyframe_events()
        else:
            self._synchronous_keyframe_path()
        self._frame_times.append(time.perf_counter() - t0)
        return T

    def process_prestaged(self, staged) -> np.ndarray:
        """Dataset-playback fast path: frames were pre-uploaded to the
        device in chunks (tracker.prestage) so the odometry loop never
        waits on the transfer link; keyframe events drain exactly as in
        process()."""
        t0 = time.perf_counter()
        T = self.tracker.compute_prestaged(staged)
        self._consume_keyframe_events()
        self._frame_times.append(time.perf_counter() - t0)
        return T

    def _flush_tracker(self):
        if hasattr(self.tracker, "flush"):
            self.tracker.flush()
            self._consume_keyframe_events()
            # Drain the deferred closure pipeline to empty (query ->
            # ICP -> closure needs two resolve passes).  Direct device_gets
            # here; discard any armed piggyback so a later drain cannot
            # deliver stale results against different handle lists.
            while self._inflight_queries or self._inflight_icp:
                self._resolve_inflight()
            if hasattr(self.tracker, "set_pending_extra"):
                self.tracker.set_pending_extra(None)
                self.tracker.take_fetched_extra()

    def _consume_keyframe_events(self):
        """Pipelined keyframe path: register every harvested snapshot and
        DISPATCH its closure query (one fused query+insert device program,
        no sync), then resolve the queries afterwards — closure search
        overlaps the tracker's dispatched work instead of stalling it.
        World-frame corrections from a resolved closure are global
        (rewrite every keyframe pose / the landmark table / the stored
        trajectory), so registering all snapshots first is exact."""
        snaps = self.tracker.pop_keyframes()
        # Register new keyframes FIRST: corrections from closures resolved
        # below then rewrite their poses along with everything else.
        local_maps = [self._register_keyframe(snap) for snap in snaps]
        # Ring-backed snapshots keep their descriptors ON DEVICE: gather
        # the batch's blocks device-side (one tiny dispatch, no transfer)
        # for the relocalizer's fused query+insert — the descriptor block
        # would be the dominant drain/upload payload.
        need = [
            (lm, s)
            for lm, s in zip(local_maps, snaps)
            if s.desc is None and s.ring_row >= 0
        ]
        if need:
            from vslam_tpu.tracking import fused as fused_mod

            bucket = 1 << max(len(need) - 1, 0).bit_length()
            rows = np.zeros(bucket, np.int32)
            rows[: len(need)] = [s.ring_row for _, s in need]
            desc_dev = fused_mod.gather_kf_desc(
                self.tracker.state.kf_desc, jnp.asarray(rows),
                out_cap=self.relocalizer.QUERY_CAP,
            )
            for i, (lm, _) in enumerate(need):
                lm.desc_dev = desc_dev[i]
        # Resolve last drain's dispatched queries/ICPs — their results
        # rode the drain-bundle transfer (tracker.take_fetched_extra), so
        # no extra round trip happens here.
        fetched = None
        piggyback = hasattr(self.tracker, "take_fetched_extra")
        if piggyback:
            fetched = self.tracker.take_fetched_extra()
        # Piggyback-capable trackers resolve ONLY when a drain delivered
        # the results — a direct device_get here would stall the pipeline
        # on every frame between drains (flush resolves directly instead).
        if fetched is not None or not piggyback:
            self._resolve_inflight(fetched)
        if local_maps:
            if self.open_loop:
                for local_map in local_maps:
                    self.relocalizer.add_local_map(local_map)
            else:
                with log.measure("relocalization"):
                    # One fused query+insert program for the whole drain's
                    # keyframes; results are fetched at the NEXT drain so
                    # closure search never blocks tracking.
                    handles = self.relocalizer.submit_batch(local_maps)
                    self._inflight_queries.extend(
                        h for h in handles if h is not None
                    )
        # Arm the next drain to carry this round's pending device results.
        if hasattr(self.tracker, "set_pending_extra"):
            q = [(h.idx_dev, h.ok_dev) for h in self._inflight_queries]
            # One device result per ICP BATCH (jobs share it) — fetching a
            # per-job slice would move the same bytes B times.
            batches = []
            for j in self._inflight_icp:
                if j.batch not in batches:
                    batches.append(j.batch)
            self._armed_icp_batches = batches
            icp = [b.res_dev for b in batches]
            self.tracker.set_pending_extra((q, icp) if (q or icp) else None)

    def _resolve_inflight(self, fetched=None):
        """Resolve every in-flight closure query result and ICP result:
        finished ICPs become applied closures, voted queries dispatch
        their ICP (fetched next time around).  `fetched` carries the
        results pre-fetched with the drain bundle; when absent (flush
        path) ONE device_get fetches everything."""
        queries, icps = self._inflight_queries, self._inflight_icp
        if not queries and not icps:
            return
        self._inflight_queries, self._inflight_icp = [], []
        closures = []
        with log.measure("relocalization"):
            if fetched is not None:
                fetched_q, fetched_icp = fetched
                for b, res in zip(
                    getattr(self, "_armed_icp_batches", []), fetched_icp
                ):
                    b.fetched = res
            else:
                fetched_q = jax.device_get(
                    [(h.idx_dev, h.ok_dev) for h in queries]
                )
                # flush path: job_result fetches each batch directly below
            # Older work first: ICP verdicts -> closures to apply.
            for job in icps:
                closure = self.relocalizer.finish_icp(
                    job, self.relocalizer.job_result(job)
                )
                if closure is not None:
                    closures.append(closure)
            with log.measure("reloc_vote_icp"):
                # Vote (host) per query, then verify ALL survivors with
                # ONE batched upload + vmapped ICP program — per-candidate
                # uploads each serialize behind the in-flight frame chunk
                # (~80 ms measured at keyframe-dense scale).
                cands = []
                for h, (idx, ok) in zip(queries, fetched_q):
                    h.idx_dev, h.ok_dev = idx, ok
                    c = self.relocalizer.vote(h)
                    if c is not None:
                        cands.append(c)
                self._inflight_icp.extend(
                    self.relocalizer.dispatch_icp_batch(cands)
                )
        # Record every closure, optimize ONCE for the batch (and only when
        # some closure actually disagrees with the current estimate —
        # residual gate), then merge ALL the batch's corresponding
        # landmarks in ONE union-find + device pass.  Per-closure merging
        # uploaded a remap LUT per closure, and each upload serializes
        # behind the in-flight frame chunk; batching makes it one wait per
        # drain.  Merge-after-optimize also matches the reference order
        # (mergeLandmarks after optimizePoseGraph, world_map.cpp:305).
        new_edges = []
        all_corr = []
        for closure in closures:
            self._record_closure(closure)
            new_edges.append(
                (closure.reference_id, closure.query_id, closure.T_ref_query)
            )
            corr = np.asarray(closure.correspondences)
            if len(corr):
                all_corr.append(corr)
        if closures and self._closures_need_optimization(new_edges):
            with log.measure("pose_graph_optimization"):
                self._optimize_pose_graph()
        if all_corr:
            with log.measure("landmark_merging"):
                self._merge_correspondences(np.concatenate(all_corr))

    def _synchronous_keyframe_path(self):
        """Host-side keyframe trigger for the modular tracker (reference
        world_map.cpp:108-111)."""
        tracker = self.tracker
        T = tracker.T_world_cam
        if not self.world_map.should_create_local_map(T):
            return
        # Reset the trigger window whether or not a local map materializes
        # (otherwise the trigger re-fires every frame while landmarks are
        # still too few — round-1 flush-collapse bug).
        self.world_map.note_trigger(T)
        frame = tracker.prev_frame
        if frame is None:
            return
        valid = np.asarray(frame.valid)
        slots = np.asarray(frame.landmark_slot)
        sel = valid & (slots >= 0)
        if sel.sum() < self.cfg.local_map.minimum_number_of_landmarks:
            return
        rows = np.flatnonzero(sel)
        rows = rows[: self.cfg.local_map.maximum_number_of_landmarks]
        lm_slots = slots[rows]
        snap = KeyframeSnapshot(
            map_id=len(self.world_map.local_maps),
            frame_idx=tracker.frame_idx - 1,
            T_world_kf=T.copy(),
            slots=lm_slots,
            xyz_w=np.asarray(tracker.table.xyz_w)[lm_slots],
            desc=np.asarray(tracker.table.desc)[lm_slots],
            uv4=np.asarray(frame.uv4)[rows],
        )
        tracker.kf_count = snap.map_id + 1
        self._handle_keyframe(snap)

    # ------------------------------------------------------------------
    def _handle_keyframe(self, snap: KeyframeSnapshot) -> np.ndarray | None:
        """Synchronous keyframe path (modular-tracker fallback): register
        the snapshot, then query+verify immediately.

        Returns the most-recent-segment correction (4,4) if a pose-graph
        optimization ran, else None.
        """
        local_map = self._register_keyframe(snap)
        if self.open_loop:
            self.relocalizer.add_local_map(local_map)
            return None
        with log.measure("relocalization"):
            closure = self.relocalizer.resolve(self.relocalizer.submit(local_map))
        if closure is None:
            return None
        return self._apply_closure(closure)

    def _register_keyframe(self, snap: KeyframeSnapshot):
        """Local-map creation + pose-graph vertex/odometry bookkeeping + BA
        cadence for one keyframe event; returns the new LocalMap."""
        assert snap.map_id == len(self.world_map.local_maps), (
            snap.map_id,
            len(self.world_map.local_maps),
        )
        local_map = self.world_map.create_local_map(
            snap.T_world_kf, snap.frame_idx, snap.slots, snap.xyz_w, snap.desc,
            uv4=snap.uv4,
        )
        local_map.ring_row = snap.ring_row

        # Pose-graph vertex + odometry edge (break-aware weight).
        self.kf_poses.append(snap.T_world_kf.copy())
        self.kf_frame_indices.append(snap.frame_idx)
        if len(self.kf_poses) > 1:
            self.kf_odometry.append(
                np.linalg.inv(self.kf_poses[-2]) @ self.kf_poses[-1]
            )
            prev_fidx = self.kf_frame_indices[-2]
            breaks = getattr(self.tracker, "_break_frames", [])
            spans_break = any(
                prev_fidx < b <= snap.frame_idx
                for b in breaks[self._breaks_consumed :]
            )
            self._breaks_consumed = len(breaks)
            self.kf_odom_weight.append(
                BREAK_EDGE_WEIGHT if spans_break else 1.0
            )

        # Keyframe overlay dump (ImageViewer parity, image_viewer.cpp:84-155).
        if self._viz_enabled:
            img = self._viz_ring.get(snap.frame_idx)
            if img is not None and snap.uv4 is not None:
                import os

                from vslam_tpu.viz import plots

                uv = np.asarray(snap.uv4)[:, :2]
                plots.draw_frame_overlay(
                    img,
                    uv,
                    has_landmark=np.asarray(snap.slots) >= 0,
                    valid=np.isfinite(uv).all(axis=1),
                    path=os.path.join(
                        self._viz_dir, f"overlay_{snap.frame_idx:06d}.png"
                    ),
                )

        # Full BA runs on its frame cadence regardless of relocalization
        # (reference optimizeFactorGraph is gated only on the BA flag +
        # cadence, slam_assembly.cpp:558-568).
        self._maybe_run_bundle_adjustment(snap)
        return local_map

    def _record_closure(self, closure):
        """Record a verified closure: world-map bookkeeping + pose-graph
        edge.  T_ref_query maps query-keyframe coords into
        reference-keyframe coords, i.e. the measured relative pose
        T_{ref<-query}; the pose graph wants T_ij = T_i^-1 T_j with
        i=reference vertex.  ONE closure edge per query map (reference
        Relocalizer::prune keeps the best closure per query,
        relocalizer.cpp:190-224): a re-verified query replaces its
        previous edge."""
        self.world_map.add_closure(closure)
        edge = (closure.reference_id, closure.query_id, closure.T_ref_query)
        for k, (_, qid, _) in enumerate(self.closure_edges):
            if qid == closure.query_id:
                self.closure_edges[k] = edge
                break
        else:
            self.closure_edges.append(edge)
        return edge

    def _apply_closure(self, closure, optimize: bool = True) -> np.ndarray | None:
        """Synchronous path (modular tracker): record + optimize + merge
        one closure; the pipelined path batches all three per drain.
        Returns the last-segment correction."""
        edge = self._record_closure(closure)
        correction = None
        if optimize and self._closures_need_optimization([edge]):
            with log.measure("pose_graph_optimization"):
                correction = self._optimize_pose_graph()

        # Merge corresponding landmarks (reference mergeLandmarks after
        # closure optimization, world_map.cpp:305).
        corr = np.asarray(closure.correspondences)
        if len(corr):
            with log.measure("landmark_merging"):
                self._merge_correspondences(corr)

        return correction

    def _maybe_run_bundle_adjustment(self, snap: KeyframeSnapshot):
        """Full BA every number_of_frames_per_bundle_adjustment frames
        (reference optimizeFactorGraph cadence, graph_optimizer.cpp:459)."""
        gopt = self.cfg.graph_optimization
        if (
            gopt.enable_full_bundle_adjustment
            and len(self.kf_poses) >= 2
            and snap.frame_idx - self._last_ba_frame
            >= gopt.number_of_frames_per_bundle_adjustment
        ):
            self._last_ba_frame = snap.frame_idx
            with log.measure("bundle_adjustment"):
                self._run_bundle_adjustment()

    def _merge_correspondences(self, corr: np.ndarray):
        """Merge landmark pairs from one or many closures in ONE union-find
        + one device pass + one remap application."""
        tracker = self.tracker
        # Translate through merges already applied this run: with batched
        # query resolution a closure's correspondences may reference slots an
        # earlier closure in the same batch absorbed.
        if self._slot_remap and len(corr):
            corr = np.vectorize(lambda s: self._slot_remap.get(int(s), int(s)))(
                corr
            ).astype(np.int32)
            corr = corr[corr[:, 0] != corr[:, 1]]
        tracker.table, remap = merging.merge_landmarks(
            tracker.table, tracker.allocator, corr
        )
        self.n_merges += len(remap)
        if not remap:
            return
        # Fold into the cumulative remap (compress chains).
        for k, v in self._slot_remap.items():
            self._slot_remap[k] = remap.get(v, v)
        self._slot_remap.update(remap)
        # Every external slot reference follows the merge: live frame,
        # local maps, and the relocalizer's row metadata (reference
        # LocalMap::replace, local_map.cpp:109-127).  One LUT pass per
        # array instead of a per-pair equality scan — the scan is
        # O(maps x pairs x K) and dominates closure host work at
        # KITTI-00 scale.
        cap = tracker.table.capacity
        lut = np.arange(cap, dtype=np.int32)
        for src, dst in remap.items():
            lut[src] = dst
        lut = lut[lut]  # compress one chain level (remaps are pre-compressed)

        def follow(arr):
            a = np.asarray(arr)
            out = a.copy()
            pos = a >= 0
            out[pos] = lut[a[pos]]
            return out

        if tracker.prev_frame is not None:
            # Remap ON DEVICE: np.asarray(landmark_slot) would be a
            # blocking device->host fetch in the middle of the closure
            # path.
            tracker.prev_frame = tracker.prev_frame._replace(
                landmark_slot=_remap_slots_device(
                    tracker.prev_frame.landmark_slot, jnp.asarray(lut)
                )
            )
        for m in self.world_map.local_maps:
            m.landmark_slots = follow(m.landmark_slots)
        self.relocalizer.apply_remap(remap, lut=lut)

    # ------------------------------------------------------------------
    def _closures_need_optimization(self, new_edges) -> bool:
        """Residual gate (an addition of this framework, see config): optimize only
        when some pending closure disagrees with the current estimate —
        at KITTI-00 scale closures fire on most keyframes, and after the
        first correction the rest are already satisfied."""
        gopt = self.cfg.graph_optimization
        gate_t = gopt.minimum_closure_residual_for_optimization_meters
        gate_r = np.deg2rad(
            gopt.minimum_closure_residual_for_optimization_degrees
        )
        if gate_t <= 0.0:
            return True
        for (i, j, T_ij) in new_edges:
            E = np.linalg.inv(T_ij) @ (
                np.linalg.inv(self.kf_poses[i]) @ self.kf_poses[j]
            )
            t_err = float(np.linalg.norm(E[:3, 3]))
            c = np.clip((np.trace(E[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
            if t_err > gate_t or float(np.arccos(c)) > gate_r:
                return True
        return False

    def _optimize_pose_graph(self) -> np.ndarray | None:
        """Optimize keyframe poses; rigidly back-propagate per-keyframe
        corrections into the landmark table (by origin local map), the
        full stored trajectory (by owning segment) and the live tracker
        pose (reference optimizePoseGraph back-propagation,
        graph_optimizer.cpp:411-457 + local_map.cpp:129-142).

        Uses the hierarchical junction solver (backend/pose_graph.py):
        compacted closures -> junction reduction -> dense GN -> geodesic
        interior distribution.  O(J^3 + P) per call vs the r3 chain path's
        f32-fragile O(P*C) Woodbury (1.45 s/call and divergent at 341
        keyframes — VERDICT r3 #1/#2).

        Returns the last-segment correction, or None if no optimization ran.
        """
        n = len(self.kf_poses)
        if n < 3 or not self.closure_edges:
            return None
        gopt = self.cfg.graph_optimization
        with log.measure("pg_solve"):
            opt, _ = pg.optimize_pose_graph_hierarchical(
                np.stack(self.kf_poses).astype(np.float32),
                np.stack(self.kf_odometry).astype(np.float32),
                np.asarray(self.kf_odom_weight, np.float32),
                self.closure_edges,
                iterations=gopt.maximum_number_of_iterations,
                robust_kernel_chi2=(
                    1.0 if gopt.enable_robust_kernel_for_poses else 1e12
                ),
                closure_bucket=gopt.closure_compaction_bucket,
                levenberg=gopt.optimization_algorithm.upper()
                in ("LEVENBERG", "DOGLEG"),
            )
        with log.measure("pg_propagate"):
            C_last = self._propagate_corrections(opt)
        self.n_optimizations += 1
        return C_last

    def _propagate_corrections(self, opt_poses: np.ndarray) -> np.ndarray:
        """Apply per-keyframe rigid corrections everywhere; returns the
        last-segment correction."""
        tracker = self.tracker
        n = len(self.kf_poses)
        corrections = np.stack(
            [
                opt_poses[k] @ np.linalg.inv(self.kf_poses[k])
                for k in range(n)
            ]
        ).astype(np.float32)
        # Back-propagation delta gate (reference
        # minimum_estimation_delta_for_update_meters,
        # graph_optimizer.cpp:430-450): micro-corrections below the gate are
        # suppressed — the keyframe keeps its previous pose and nothing
        # downstream moves for it.
        gate = self.cfg.graph_optimization.minimum_estimation_delta_for_update_meters
        if gate > 0.0:
            # Full matrix-difference norm (graph_optimizer.cpp:433): a
            # rotation-only correction above threshold must propagate too.
            small = (
                np.linalg.norm(
                    corrections - np.eye(4, dtype=np.float32), axis=(1, 2)
                )
                < gate
            )
            if small.any():
                corrections[small] = np.eye(4, dtype=np.float32)
                opt_poses = opt_poses.copy()
                opt_poses[small] = np.stack(
                    [self.kf_poses[k] for k in np.flatnonzero(small)]
                )

        # Landmarks move with their ORIGIN local map (recorded at spawn in
        # table.origin_kf) — pad the correction array to power-of-two
        # buckets so the device program compiles once per bucket.
        def pow2(x):
            return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 3)

        C_pad = np.tile(np.eye(4, dtype=np.float32), (pow2(n), 1, 1))
        C_pad[:n] = corrections
        tracker.table = lm_mod.apply_kf_corrections(
            tracker.table, jnp.asarray(C_pad), jnp.int32(n)
        )

        # Full stored trajectory: every frame moves with its owning keyframe
        # segment (frame f belongs to the local map whose window contains
        # it: the first keyframe with frame index >= f).
        traj = tracker.trajectory
        if traj:
            kf_frames = np.asarray(self.kf_frame_indices)
            f_idx = np.arange(len(traj))
            owner = np.searchsorted(kf_frames, f_idx, side="left")
            owner = np.clip(owner, 0, n - 1)
            stacked = np.stack(traj).astype(np.float32)
            stacked = np.einsum("fij,fjk->fik", corrections[owner], stacked)
            tracker.trajectory = [stacked[f] for f in range(len(traj))]

        # Live tracker pose + any in-flight frames move with the last
        # keyframe's correction.
        C_last = corrections[-1]
        if hasattr(tracker, "apply_world_correction"):
            tracker.apply_world_correction(C_last)
        else:
            tracker.T_world_cam = (C_last @ tracker.T_world_cam).astype(
                np.float32
            )

        # Keyframe bookkeeping adopts the optimized poses.
        self.kf_poses = [opt_poses[k].copy() for k in range(n)]
        for k, m in enumerate(self.world_map.local_maps):
            m.T_world_kf = opt_poses[k].copy()
        if self.world_map._last_T is not None:
            self.world_map._last_T = (C_last @ self.world_map._last_T).astype(
                np.float32
            )
        return C_last

    # ------------------------------------------------------------------
    def _run_bundle_adjustment(self):
        """Windowed full BA over recent keyframes (wired in backend/ba.py);
        placeholder hook — populated by the BA milestone."""
        from vslam_tpu.system import ba_runner

        C_last = ba_runner.run_windowed_ba(self)
        if C_last is not None:
            self.n_ba_runs += 1

    # ------------------------------------------------------------------
    @property
    def trajectory(self) -> np.ndarray:
        self._flush_tracker()
        return np.stack(self.tracker.trajectory)

    def report_lite(self) -> dict:
        """Status-line statistics WITHOUT draining the device pipeline
        (reference 5-second status line, slam_assembly.cpp:453-477, costs
        nothing; report() flushes and is for end-of-run only).  Values lag
        by up to one drain interval."""
        ft = np.asarray(self._frame_times) if self._frame_times else np.zeros(1)
        stats = self.tracker.stats
        return {
            "total_frames": stats.n_frames,
            "mean_frame_hz": round(float(1.0 / max(ft.mean(), 1e-9)), 2),
            # n_spawned from harvested stats — NOT allocator.num_allocated,
            # which reads a device scalar and would stall the pipeline.
            "n_landmarks": stats.n_spawned,
            "n_local_maps": len(self.world_map),
            "n_closures": len(self.world_map.closures),
            "n_optimizations": self.n_optimizations,
            "n_track_breaks": stats.n_breaks,
        }

    def report(self) -> dict:
        """printReport parity (slam_assembly.cpp:622-744)."""
        self._flush_tracker()
        ft = np.asarray(self._frame_times) if self._frame_times else np.zeros(1)
        stats = self.tracker.stats
        total = time.perf_counter() - self._t_start
        rep = {
            "total_frames": stats.n_frames,
            "total_compute_time_s": round(float(ft.sum()), 3),
            "mean_frame_time_s": round(float(ft.mean()), 4),
            "mean_frame_hz": round(float(1.0 / max(ft.mean(), 1e-9)), 2),
            "median_frame_time_s": round(float(np.median(ft)), 4),
            "max_frame_time_s": round(float(ft.max()), 4),
            "wall_time_s": round(total, 3),
            "n_landmarks": self.tracker.allocator.num_allocated,
            "n_local_maps": len(self.world_map),
            "n_closures": len(self.world_map.closures),
            "n_optimizations": self.n_optimizations,
            "n_ba_runs": self.n_ba_runs,
            "n_merged_landmarks": self.n_merges,
            "n_track_breaks": stats.n_breaks,
            "n_recovered_landmarks": stats.n_recovered,
            "stage_seconds": {
                k: round(v, 3) for k, v in stats.stage_seconds.items()
            },
            # Reference printReport's relative/absolute per-module table
            # (slam_assembly.cpp:705-742), fed by utils.log chronometers.
            "stage_table": log.chronometers.report(),
        }
        return rep

    def print_report(self):
        rep = self.report()
        print("-" * 60)
        print("vslam_tpu run report")
        for k, v in rep.items():
            print(f"  {k:26s} {v}")
        print("-" * 60)
