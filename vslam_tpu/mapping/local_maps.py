"""Keyframes / local maps and the world map bookkeeping.

Array-program redesign of LocalMap + WorldMap (src/types/local_map.cpp:27-96,
world_map.cpp:50-478): a LocalMap is a keyframe-anchored record holding the
slots + keyframe-frame snapshot positions + packed descriptor block of the
landmarks seen in its window — the descriptor block is exactly the matrix
a Hamming-matmul loop-closure query consumes (SURVEY.md §2.5).  The world
map is a light host object: local-map list, per-landmark origin map id,
and the local-map creation trigger.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from vslam_tpu.ops import lie

import jax.numpy as jnp


@dataclass
class LocalMap:
    map_id: int
    keyframe_index: int  # frame index of the anchoring keyframe
    T_world_kf: np.ndarray  # (4, 4) keyframe pose at creation
    landmark_slots: np.ndarray  # (K,) int32 table slots
    xyz_kf: np.ndarray  # (K, 3) landmark positions in keyframe frame
    # Landmark descriptors: None when device-resident (the fused tracker's
    # snapshot ring keeps them on device; `desc_dev` carries the padded
    # device gather the relocalizer consumes — fused.gather_kf_desc).
    desc: np.ndarray | None  # (K, 8) uint32, or None
    # Stereo observations [uL,vL,uR,vR] of each landmark in the keyframe —
    # the measurement rows of the full-BA factor graph (reference
    # addPoseWithFactors, graph_optimizer.cpp:319-409).
    uv4: np.ndarray | None = None
    desc_dev: object = None  # (QUERY_CAP, 8) uint32 device array, or None
    ring_row: int = -1  # device snapshot-archive row (-1: not ring-backed)


@dataclass
class Closure:
    """A verified loop closure (reference src/relocalization/closure.h)."""

    query_id: int
    reference_id: int
    T_ref_query: np.ndarray  # (4, 4) aligning query keyframe into reference
    n_correspondences: int
    inlier_ratio: float
    correspondences: np.ndarray  # (C, 2) [query_slot, reference_slot]


class WorldMap:
    """Host-side global map owner (reference src/types/world_map.cpp)."""

    def __init__(
        self,
        min_distance: float = 0.5,
        min_degrees: float = 30.0,
        min_frames: int = 4,
    ):
        self.local_maps: list[LocalMap] = []
        self.closures: list[Closure] = []
        self.min_distance = min_distance
        self.min_radians = np.deg2rad(min_degrees)
        self.min_frames = min_frames
        self._last_T = None
        self._frames_since = 0

    def should_create_local_map(self, T_world_cam: np.ndarray) -> bool:
        """Reference trigger: rotation > threshold OR (distance AND >= N
        frames) since the last local map (world_map.cpp:108-111)."""
        self._frames_since += 1
        if self._last_T is None:
            return True
        dT = np.linalg.inv(self._last_T) @ T_world_cam
        dist = float(np.linalg.norm(dT[:3, 3]))
        ang = float(lie.rotation_angle(jnp.asarray(dT[:3, :3].astype(np.float32))))
        if ang > self.min_radians:
            return True
        return dist > self.min_distance and self._frames_since >= self.min_frames

    def note_trigger(self, T_world_cam: np.ndarray) -> None:
        """Reset the trigger window (called when the trigger fires, whether
        or not a local map materializes — prevents per-frame re-firing
        while landmarks are still too few)."""
        self._last_T = T_world_cam.copy()
        self._frames_since = 0

    def create_local_map(
        self,
        T_world_cam: np.ndarray,
        frame_index: int,
        landmark_slots: np.ndarray,
        xyz_world: np.ndarray,
        desc: np.ndarray | None,
        uv4: np.ndarray | None = None,
    ) -> LocalMap:
        T_kf_world = np.linalg.inv(T_world_cam)
        xyz_kf = xyz_world @ T_kf_world[:3, :3].T + T_kf_world[:3, 3]
        lm = LocalMap(
            map_id=len(self.local_maps),
            keyframe_index=frame_index,
            T_world_kf=T_world_cam.copy(),
            landmark_slots=np.array(landmark_slots, np.int32),
            xyz_kf=xyz_kf.astype(np.float32),
            desc=None if desc is None else np.asarray(desc, np.uint32),
            uv4=None if uv4 is None else np.asarray(uv4, np.float32),
        )
        self.local_maps.append(lm)
        self.note_trigger(T_world_cam)
        return lm

    def add_closure(self, closure: Closure):
        self.closures.append(closure)

    def __len__(self):
        return len(self.local_maps)
