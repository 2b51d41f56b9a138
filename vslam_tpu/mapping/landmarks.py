"""Device-resident landmark table with host-side slot allocation.

The array-program replacement for the reference's heap-allocated Landmark
objects and their per-landmark Gauss-Newton refinement
(src/types/landmark.h:20-35, landmark.cpp:66-167): fixed-capacity device
arrays (SoA), batched information-form GN updates (solve/aligners.py
update_landmarks), and a host free-list for allocation — landmark `merge`
(landmark.cpp:169-265) becomes id-relabeling over these columns
(mapping/merging.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vslam_tpu.ops import camera as cam_ops
from vslam_tpu.ops import lie
from vslam_tpu.solve import aligners


class LandmarkTable(NamedTuple):
    xyz_w: jnp.ndarray  # (M, 3) world positions
    H_acc: jnp.ndarray  # (M, 3, 3) accumulated information
    desc: jnp.ndarray  # (M, 8) uint32 most recent descriptor
    n_updates: jnp.ndarray  # (M,) int32
    last_seen: jnp.ndarray  # (M,) int32 frame index
    valid: jnp.ndarray  # (M,) bool
    # Owning local map at creation (reference: a Landmark belongs to the
    # LocalMap whose window spawned it, local_map.cpp:41-76) — drives rigid
    # back-propagation after pose-graph optimization.
    origin_kf: jnp.ndarray  # (M,) int32 local-map id (kf_count at spawn)
    # True once the landmark entered a local-map snapshot / the closure DB:
    # such slots are referenced externally and must never be recycled.
    protected: jnp.ndarray  # (M,) bool

    @property
    def capacity(self):
        return self.xyz_w.shape[0]


def empty_table(capacity: int) -> LandmarkTable:
    return LandmarkTable(
        xyz_w=jnp.zeros((capacity, 3), jnp.float32),
        H_acc=jnp.zeros((capacity, 3, 3), jnp.float32),
        desc=jnp.zeros((capacity, 8), jnp.uint32),
        n_updates=jnp.zeros(capacity, jnp.int32),
        last_seen=jnp.full(capacity, -1, jnp.int32),
        valid=jnp.zeros(capacity, bool),
        origin_kf=jnp.zeros(capacity, jnp.int32),
        protected=jnp.zeros(capacity, bool),
    )


@jax.jit
def landmark_weights(table: LandmarkTable, slots: jnp.ndarray) -> jnp.ndarray:
    """Per-framepoint pose-solver weight: 1 + log(1 + n_updates) for
    landmark-backed points, 1 otherwise (reference
    stereouv_aligner.cpp:40-46)."""
    has_lm = slots >= 0
    n = table.n_updates[jnp.where(has_lm, slots, 0)]
    w = 1.0 + jnp.log1p(n.astype(jnp.float32))
    return jnp.where(has_lm, w, 1.0)


@jax.jit
def spawn_landmarks(
    table: LandmarkTable,
    new_slots: jnp.ndarray,  # (S,) int32 table slots to fill (-1 = unused row)
    xyz_w: jnp.ndarray,  # (S, 3) initial world positions
    desc: jnp.ndarray,  # (S, 8)
    frame_idx: jnp.ndarray,
    origin_kf: jnp.ndarray = jnp.int32(0),  # owning local-map id at spawn
) -> LandmarkTable:
    """Scatter freshly-created landmarks into their assigned slots.

    All scatters are predicated ADD-deltas (never .set): every unused row
    targets slot 0, and duplicate-index .set is nondeterministic when a
    genuine spawn also targets slot 0 — adding a zero delta is safe.  The
    allocator guarantees each used slot appears at most once.
    """
    use = new_slots >= 0
    tgt = jnp.where(use, new_slots, 0)
    u1 = use[:, None]
    xyz = table.xyz_w.at[tgt].add(jnp.where(u1, xyz_w - table.xyz_w[tgt], 0.0))
    H = table.H_acc.at[tgt].add(
        jnp.where(use[:, None, None], -table.H_acc[tgt], 0.0)
    )
    # uint32 delta-add is exact mod 2^32: cur + (new - cur) == new.
    desc_new = table.desc.at[tgt].add(jnp.where(u1, desc - table.desc[tgt], jnp.uint32(0)))
    n_up = table.n_updates.at[tgt].add(jnp.where(use, 1 - table.n_updates[tgt], 0))
    last = table.last_seen.at[tgt].max(jnp.where(use, frame_idx, -1))
    valid = table.valid.at[tgt].max(use)
    origin = table.origin_kf.at[tgt].add(
        jnp.where(use, origin_kf - table.origin_kf[tgt], 0)
    )
    # Recycled slots start unprotected.  .min is collision-safe: unused rows
    # alias slot 0 but contribute True = identity under min.
    prot = table.protected.at[tgt].min(~use)
    return table._replace(
        xyz_w=xyz, H_acc=H, desc=desc_new, n_updates=n_up, last_seen=last, valid=valid,
        origin_kf=origin, protected=prot,
    )


@partial(jax.jit, static_argnames=("mode", "min_forced_updates",
                                   "min_meas_for_opt",
                                   "max_t_err_depth_ratio"))
def update_observed(
    cam: cam_ops.CameraParams,
    table: LandmarkTable,
    T_world_cam: jnp.ndarray,
    slots: jnp.ndarray,  # (K,) landmark slot per framepoint (-1 none)
    uv4: jnp.ndarray,  # (K, 4) stereo [uL,vL,uR,vR] or depth [u,v,z,0]
    desc: jnp.ndarray,  # (K, 8) current descriptors
    point_valid: jnp.ndarray,  # (K,)
    frame_idx: jnp.ndarray,
    mode: str = "stereo",
    min_forced_updates: int = 0,
    min_meas_for_opt: int = 0,
    max_t_err_depth_ratio: float = 0.0,
) -> LandmarkTable:
    """Batched GN refinement of all landmarks observed this frame.

    Scatters frame measurements into table-aligned arrays, runs the vmapped
    information-form update, refreshes descriptors / counters.  The
    LandmarkParameters knobs pass through to aligners.update_landmarks.
    """
    obs = point_valid & (slots >= 0)
    tgt = jnp.where(obs, slots, 0)
    obs = obs & table.valid[tgt]

    # Gather only the K observed landmarks (K = frame capacity, typically
    # 64x smaller than the table): the vmapped 3x3 GN refinement runs on
    # K rows instead of the whole table, then results scatter back.  The
    # allocator guarantees distinct frame points hold distinct slots, so
    # the .set scatters hit disjoint rows (unused rows alias slot 0 but
    # write back the unmodified gathered values).
    xyz_g = table.xyz_w[tgt]
    H_g = table.H_acc[tgt]
    n_up_g = table.n_updates[tgt]

    if mode == "stereo":
        xyz_n, H_n, chi2, inlier = aligners.update_landmarks(
            cam, xyz_g, H_g, T_world_cam, uv4, obs,
            n_updates=n_up_g,
            min_forced_updates=min_forced_updates,
            min_meas_for_opt=min_meas_for_opt,
            max_t_err_depth_ratio=max_t_err_depth_ratio,
        )
    else:
        xyz_n, H_n, chi2, inlier = aligners.update_landmarks_uvd(
            cam, xyz_g, H_g, T_world_cam, uv4[:, :3], obs
        )

    # Predicated ADD-deltas, never .set: unused rows alias slot 0, and a
    # duplicate-index .set is nondeterministic when a genuine observation
    # also targets slot 0 — adding a zero delta is safe (cf.
    # spawn_landmarks).
    o1 = obs[:, None]
    return table._replace(
        xyz_w=table.xyz_w.at[tgt].add(jnp.where(o1, xyz_n - xyz_g, 0.0)),
        H_acc=table.H_acc.at[tgt].add(
            jnp.where(obs[:, None, None], H_n - H_g, 0.0)
        ),
        # uint32 delta-add is exact mod 2^32: cur + (new - cur) == new.
        desc=table.desc.at[tgt].add(
            jnp.where(o1, desc - table.desc[tgt], jnp.uint32(0))
        ),
        n_updates=table.n_updates.at[tgt].add(obs.astype(jnp.int32)),
        last_seen=table.last_seen.at[tgt].max(
            jnp.where(obs, frame_idx, -1)
        ),
    )


@partial(jax.jit, static_argnames=("mode", "min_forced_updates",
                                   "min_meas_for_opt",
                                   "max_t_err_depth_ratio"))
def spawn_and_update_observed(
    cam: cam_ops.CameraParams,
    table: LandmarkTable,
    T_world_cam: jnp.ndarray,
    slots: jnp.ndarray,  # (K,) slot per framepoint incl. FRESH ones (-1 none)
    fresh: jnp.ndarray,  # (K,) True where the slot was assigned this frame
    p_cam: jnp.ndarray,  # (K, 3) current-camera positions (spawn init)
    uv4: jnp.ndarray,  # (K, 4)
    desc: jnp.ndarray,  # (K, 8)
    point_valid: jnp.ndarray,  # (K,)
    frame_idx: jnp.ndarray,
    origin_kf: jnp.ndarray,
    mode: str = "stereo",
    min_forced_updates: int = 0,
    min_meas_for_opt: int = 0,
    max_t_err_depth_ratio: float = 0.0,
) -> LandmarkTable:
    """Fused landmark spawn + batched GN refinement: ONE scatter per table
    field instead of spawn_landmarks + update_observed's separate passes.

    The split pair costs 13 full-table scatters per frame, this does 8.  Semantics match
    spawn_landmarks followed by update_observed exactly: fresh rows are
    initialized (n_updates=1, H=0, origin, unprotected) and then receive
    their first observation update like any other observed landmark.
    """
    obs = point_valid & (slots >= 0)
    tgt = jnp.where(obs, slots, 0)
    obs = obs & (table.valid[tgt] | fresh)

    xyz_spawn = lie.transform_point_cloud(T_world_cam, p_cam)
    f1 = fresh[:, None]
    base_xyz = jnp.where(f1, xyz_spawn, table.xyz_w[tgt])
    base_H = jnp.where(fresh[:, None, None], 0.0, table.H_acc[tgt])
    base_nup = jnp.where(fresh, 1, table.n_updates[tgt])

    if mode == "stereo":
        xyz_n, H_n, chi2, inlier = aligners.update_landmarks(
            cam, base_xyz, base_H, T_world_cam, uv4, obs,
            n_updates=base_nup,
            min_forced_updates=min_forced_updates,
            min_meas_for_opt=min_meas_for_opt,
            max_t_err_depth_ratio=max_t_err_depth_ratio,
        )
    else:
        xyz_n, H_n, chi2, inlier = aligners.update_landmarks_uvd(
            cam, base_xyz, base_H, T_world_cam, uv4[:, :3], obs
        )

    o1 = obs[:, None]
    new_nup = jnp.where(obs, base_nup + 1, table.n_updates[tgt])
    new_origin = jnp.where(fresh, origin_kf, table.origin_kf[tgt])
    # Predicated ADD-deltas (collision-safe: unused rows alias slot 0 and
    # add zero, cf. spawn_landmarks), PACKED into 3 scatters: a scatter's
    # cost depends little on row width, so the f32 fields ride one (K, 12) scatter, the int/flag fields one (K, 5)
    # scatter and the descriptors one (K, 8) scatter — 3 table passes
    # instead of 8 (the concat/split round trips are contiguous copies,
    # ~us at this table size).
    cap = table.capacity
    fbuf = jnp.concatenate(
        [table.xyz_w, table.H_acc.reshape(cap, 9)], axis=1
    )
    fdelta = jnp.concatenate(
        [
            jnp.where(o1, xyz_n - table.xyz_w[tgt], 0.0),
            jnp.where(
                obs[:, None], (H_n - table.H_acc[tgt]).reshape(-1, 9), 0.0
            ),
        ],
        axis=1,
    )
    fbuf = fbuf.at[tgt].add(fdelta)

    new_seen = jnp.where(obs, jnp.maximum(table.last_seen[tgt], frame_idx),
                         table.last_seen[tgt])
    new_valid = table.valid[tgt] | obs
    new_prot = table.protected[tgt] & ~(fresh & obs)
    ibuf = jnp.stack(
        [
            table.n_updates,
            table.last_seen,
            table.origin_kf,
            table.valid.astype(jnp.int32),
            table.protected.astype(jnp.int32),
        ],
        axis=1,
    )
    idelta = jnp.stack(
        [
            jnp.where(obs, new_nup - table.n_updates[tgt], 0),
            new_seen - table.last_seen[tgt],
            jnp.where(obs, new_origin - table.origin_kf[tgt], 0),
            new_valid.astype(jnp.int32) - table.valid[tgt].astype(jnp.int32),
            new_prot.astype(jnp.int32)
            - table.protected[tgt].astype(jnp.int32),
        ],
        axis=1,
    )
    ibuf = ibuf.at[tgt].add(idelta)

    return table._replace(
        xyz_w=fbuf[:, :3],
        H_acc=fbuf[:, 3:].reshape(cap, 3, 3),
        desc=table.desc.at[tgt].add(
            jnp.where(o1, desc - table.desc[tgt], jnp.uint32(0))
        ),
        n_updates=ibuf[:, 0],
        last_seen=ibuf[:, 1],
        origin_kf=ibuf[:, 2],
        valid=ibuf[:, 3] > 0,
        protected=ibuf[:, 4] > 0,
    )


@jax.jit
def apply_kf_corrections(table: LandmarkTable, C: jnp.ndarray, n_kf: jnp.ndarray):
    """Rigidly move every landmark with its origin local map's pose-graph
    correction (reference back-propagation via LocalMap::setRobotToWorld,
    graph_optimizer.cpp:430-450 + local_map.cpp:129-142).

    C: (Kp, 4, 4) per-local-map corrections, padded with identity rows;
    n_kf: int32 count of real rows.  Landmark ownership = origin_kf
    (recorded at creation), clipped into [0, n_kf-1].
    """
    owner = jnp.clip(table.origin_kf, 0, jnp.maximum(n_kf - 1, 0))
    Co = C[owner]
    R = Co[:, :3, :3]
    xyz = jnp.einsum("nij,nj->ni", R, table.xyz_w) + Co[:, :3, 3]
    # H_acc is position information in world coordinates: conjugate by R.
    H = jnp.einsum("nij,njk,nlk->nil", R, table.H_acc, R)
    keep = table.valid[:, None]
    return table._replace(
        xyz_w=jnp.where(keep, xyz, table.xyz_w),
        H_acc=jnp.where(table.valid[:, None, None], H, table.H_acc),
    )


@jax.jit
def scatter_xyz(table: LandmarkTable, slots: jnp.ndarray, xyz_new: jnp.ndarray,
                use: jnp.ndarray) -> LandmarkTable:
    """Write back externally-optimized landmark positions (bundle
    adjustment back-propagation, graph_optimizer.cpp:478-486).  Predicated
    add-delta scatter (collision-safe, cf. spawn_landmarks)."""
    tgt = jnp.where(use, slots, 0)
    delta = jnp.where(use[:, None], xyz_new - table.xyz_w[tgt], 0.0)
    return table._replace(xyz_w=table.xyz_w.at[tgt].add(delta))


class SlotAllocator:
    """Host-side free-list over table slots (replaces heap allocation of
    Landmark objects, world_map.cpp:74-92)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._next = 0
        self._free: list[int] = []

    def allocate(self, n: int) -> np.ndarray:
        out = []
        while n > 0 and self._free:
            out.append(self._free.pop())
            n -= 1
        take = min(n, self.capacity - self._next)
        out.extend(range(self._next, self._next + take))
        self._next += take
        # If the table is full, excess requests get -1 (callers skip them).
        out.extend([-1] * (n - take))
        return np.asarray(out, np.int32)

    def release(self, slots) -> None:
        self._free.extend(int(s) for s in np.asarray(slots) if s >= 0)

    @property
    def num_allocated(self) -> int:
        return self._next - len(self._free)
