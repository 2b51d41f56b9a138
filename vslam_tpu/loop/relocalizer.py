"""Loop-closure detection and geometric verification.

Replaces the reference Relocalizer's HBST tree
(src/relocalization/relocalizer.cpp:42-280) with the Hamming-matmul
database design (SURVEY.md §2.5): every past local map's packed descriptor
block is appended to one device-resident database matrix; a query local
map is matched against the whole database in a single masked
XOR-popcount/int8-matmul program; votes are counted per reference map, and
surviving candidates are verified with the point-to-point ICP aligner
(reference XYZAligner, xyz_aligner.cpp:106-177).

Design notes:

* **One row per landmark** (not per (map, landmark) pair): consecutive
  local maps share most of their landmarks, and duplicate rows of the SAME
  landmark would defeat the second-best-margin ambiguity test.  The
  reference's HBST merges matchables of one landmark the same way
  (SRRG_MERGE_DESCRIPTORS, relocalizer.cpp:153-171).
* **Votes follow landmark membership**: a matched row votes for EVERY
  local map containing that landmark (the merged HBST matchable reports
  all its (map, landmark) references, relocalizer.cpp:86-123).  Voting
  only for the first-insertion map would split a revisit's votes across
  the several maps that first saw those landmarks and no single map would
  clear the vote gate.
* **Interspace gating lives on device**: each row carries its
  first-insertion map id (`db_map_id`); the query program masks rows with
  `map_id > query_id - interspace` before the arg-min (relocalizer.cpp:
  74-86) — no per-query host mask upload.
* **Pipelined API**: `submit(local_map)` runs insert + query as ONE
  dispatched device program and returns a handle without synchronizing;
  `resolve(handle)` later reads the small result, votes, and runs ICP only
  for surviving candidates.  The engine resolves handles after dispatching
  all of a batch's keyframe work, so closure search overlaps tracking.

The database can be row-sharded over the device mesh via
parallel/sharded_search.py — the query math is identical.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from vslam_tpu.io.config import RelocalizationParameters
from vslam_tpu.mapping.local_maps import Closure, LocalMap
from vslam_tpu.ops import hamming
from vslam_tpu.solve import aligners, gn


@jax.jit
def _query_database(q_desc, db_desc, db_map_id, max_map_id, max_distance,
                    min_margin):
    """Best match per query row under a distance gate AND a Lowe-style
    absolute margin against the second-best (the parallel equivalent of the
    reference's ratio test on knnMatch results,
    stereo_framepoint_generator.cpp:196-206): ambiguous descriptors — the
    dominant failure mode of place recognition — match many rows almost
    equally well and are rejected by the margin."""
    dist = hamming.hamming_matrix_mxu(q_desc, db_desc)
    eligible = (db_map_id >= 0) & (db_map_id <= max_map_id)
    # Two fused min-encode passes instead of top_k (XLA lowers top_k to a
    # full sort of each 100k+-row slice) or a variadic argmin (see
    # ops/hamming.min_encode).
    best_f, best = hamming.min_encode(dist, eligible[None, :], axis=1)
    best_d = best_f.astype(jnp.int32)
    cols = jax.lax.broadcasted_iota(jnp.int32, dist.shape, 1)
    dist_m = jnp.where(eligible[None, :], dist, hamming.BIG)
    second_d = jnp.min(
        jnp.where(cols == best[:, None], hamming.BIG, dist_m), axis=1
    )
    ok = (best_d <= max_distance) & (second_d - best_d >= min_margin)
    return best, ok, best_d


@partial(jax.jit, donate_argnums=(2, 3), static_argnums=(9,))
def _query_and_insert(q_desc, fresh, db_desc, db_map_id, offset, map_id,
                      max_map_id, max_distance, min_margin, prefix):
    """Fused per-keyframe program: query the CURRENT database, then append
    the query's fresh rows (mask-compacted at `offset`).  One upload + one
    dispatch per keyframe; rows inserted here carry map_id > max_map_id so
    the ordering inside the program cannot affect the query result.
    Only the active power-of-two `prefix` of the database is matched."""
    best, ok, best_d = _query_database(
        q_desc,
        jax.lax.dynamic_slice_in_dim(db_desc, 0, prefix, 0),
        jax.lax.dynamic_slice_in_dim(db_map_id, 0, prefix, 0),
        max_map_id, max_distance, min_margin,
    )
    cap = db_desc.shape[0]
    rank = jnp.cumsum(fresh.astype(jnp.int32)) - 1
    dest = offset + rank
    put = fresh & (dest < cap)
    tgt = jnp.where(put, dest, 0)
    # Predicated add-delta scatters (collision-safe: non-put rows alias 0
    # and add zero; put rows hit distinct destinations).
    db_desc = db_desc.at[tgt].add(
        jnp.where(put[:, None], q_desc - db_desc[tgt], jnp.uint32(0))
    )
    db_map_id = db_map_id.at[tgt].add(jnp.where(put, map_id - db_map_id[tgt], 0))
    return best, ok, best_d, db_desc, db_map_id


@partial(jax.jit, donate_argnums=(3, 4), static_argnums=(8,))
def _query_and_insert_many(q_desc, dest, row_map_id, db_desc, db_map_id,
                           max_map_id, max_distance, min_margin, prefix):
    """Batched fused program: S keyframe queries against the CURRENT
    database in one Hamming matmul, then all their fresh rows appended.

    One dispatch per drain instead of one per keyframe — each extra
    dispatch+upload has a fixed cost, and a drain typically carries
    several keyframes.  Exact w.r.t. the
    sequential path as long as S <= interspace (within-batch maps are
    ineligible for each other by the interspace gate anyway; the query
    reads db state from BEFORE the in-program insert).

    q_desc: (S, CAP, 8) query descriptors; dest: (S*CAP,) int32 database
    destination row per flattened query row (-1 = not fresh, don't
    insert); row_map_id: (S*CAP,) first-insertion map id to write;
    max_map_id: (S,) per-query interspace bound (-1 = padded query).
    """
    S, CAP, _ = q_desc.shape
    qs = q_desc.reshape(S * CAP, 8)
    # Only the ACTIVE power-of-two prefix of the database participates in
    # the match: the distance matrix + its two argmin passes are O(rows),
    # and matching against the full preallocated capacity (131k rows) when
    # a few thousand are live wastes 10-100x memory traffic and matmul work.
    db_active = jax.lax.dynamic_slice_in_dim(db_desc, 0, prefix, 0)
    mid_active = jax.lax.dynamic_slice_in_dim(db_map_id, 0, prefix, 0)
    dist = hamming.hamming_matrix_mxu(qs, db_active)
    bound = jnp.repeat(max_map_id, CAP)[:, None]
    eligible = (mid_active[None, :] >= 0) & (mid_active[None, :] <= bound)
    best_f, best = hamming.min_encode(dist, eligible, axis=1)
    best_d = best_f.astype(jnp.int32)
    cols = jax.lax.broadcasted_iota(jnp.int32, dist.shape, 1)
    dist_m = jnp.where(eligible, dist, hamming.BIG)
    second_d = jnp.min(
        jnp.where(cols == best[:, None], hamming.BIG, dist_m), axis=1
    )
    ok = (best_d <= max_distance) & (second_d - best_d >= min_margin)
    put = dest >= 0
    tgt = jnp.where(put, dest, 0)
    db_desc = db_desc.at[tgt].add(
        jnp.where(put[:, None], qs - db_desc[tgt], jnp.uint32(0))
    )
    db_map_id = db_map_id.at[tgt].add(
        jnp.where(put, row_map_id - db_map_id[tgt], 0)
    )
    return best.reshape(S, CAP), ok.reshape(S, CAP), db_desc, db_map_id


@partial(jax.jit, donate_argnums=(0, 1))
def _insert_only(db_desc, db_map_id, q_desc, fresh, offset, map_id):
    cap = db_desc.shape[0]
    rank = jnp.cumsum(fresh.astype(jnp.int32)) - 1
    dest = offset + rank
    put = fresh & (dest < cap)
    tgt = jnp.where(put, dest, 0)
    db_desc = db_desc.at[tgt].add(
        jnp.where(put[:, None], q_desc - db_desc[tgt], jnp.uint32(0))
    )
    db_map_id = db_map_id.at[tgt].add(jnp.where(put, map_id - db_map_id[tgt], 0))
    return db_desc, db_map_id


@jax.jit
def _eligibility(db_map_id, max_map_id):
    return (db_map_id >= 0) & (db_map_id <= max_map_id)


@dataclass
class QueryHandle:
    """An in-flight closure query (resolve with Relocalizer.resolve)."""

    query: LocalMap
    nq: int
    idx_dev: jnp.ndarray  # (QUERY_CAP,) int32 db rows
    ok_dev: jnp.ndarray  # (QUERY_CAP,) bool


@dataclass
class ICPCandidate:
    """A vote-gate survivor awaiting geometric verification (host data
    only — Relocalizer.dispatch_icp_batch uploads all of a drain's
    candidates in one transfer)."""

    query: LocalMap
    reference: LocalMap
    q_rows: np.ndarray
    r_rows: np.ndarray
    n: int


@dataclass(eq=False)
class ICPBatch:
    """One dispatched batched-ICP program's device result, shared by the
    batch's jobs: fetched ONCE (a per-job device slice would enqueue
    B x fields tiny programs and fetch the same bytes B times)."""

    res_dev: object  # vmapped gn.GNResult pytree (device), leading dim B
    fetched: object = None  # host copy once resolved


@dataclass
class ICPJob:
    """An in-flight closure ICP verification: the candidate survived the
    vote gate and its aligner has been dispatched; gate the fetched result
    with Relocalizer.finish_icp."""

    query: LocalMap
    reference: LocalMap
    q_rows: np.ndarray
    r_rows: np.ndarray
    n: int
    batch: ICPBatch
    index: int  # row of this job inside batch.res_dev


from functools import lru_cache


@lru_cache(maxsize=None)
def _batched_icp_solver(aligner_type: str, icp_config):
    """One compiled vmapped ICP program per (aligner, config); the jit
    cache then specializes per (batch, cap) bucket.  Memoized: a fresh
    jax.jit wrapper per dispatch would retrace every call."""
    if aligner_type == "FAST-ICP":
        from vslam_tpu.solve import anderson

        solve = anderson.fast_icp_align
    else:
        solve = aligners.icp_align

    return jax.jit(
        jax.vmap(lambda d, m, t: solve(d, m, t, icp_config))
    )


@lru_cache(maxsize=None)
def _batched_icp_from_archive(aligner_type: str, icp_config):
    """Batched ICP whose point sets are GATHERED ON DEVICE from the
    tracker's keyframe archive (kf_pose/kf_xyz rings): the host uploads
    only row indices + initial guesses (~40 KB) instead of the stacked
    xyz blocks (~100 KB + a blocking upload behind the in-flight chunk).

    Snapshot world positions are moved into each map's keyframe frame
    with the ARCHIVED pose: keyframe-frame coordinates are invariant
    under the rigid world corrections applied since the snapshot, so
    this matches the host path bit-for-bit up to f32 rounding."""
    if aligner_type == "FAST-ICP":
        from vslam_tpu.solve import anderson

        solve = anderson.fast_icp_align
    else:
        solve = aligners.icp_align

    @jax.jit
    def run(kf_pose, kf_xyz, qr, rr, q_rows, r_rows, nvalid, T0):
        def one(qri, rri, qrow, rrow, n, T0i):
            Tq = kf_pose[qri]
            Tr = kf_pose[rri]
            mov = (kf_xyz[qri][qrow] - Tq[:3, 3]) @ Tq[:3, :3]
            fix = (kf_xyz[rri][rrow] - Tr[:3, 3]) @ Tr[:3, :3]
            cap = qrow.shape[0]
            msk = jnp.arange(cap) < n
            data = aligners.ICPData(
                p_moving=mov, p_fixed=fix,
                weight=jnp.ones(cap, jnp.float32),
            )
            return solve(data, msk, T0i, icp_config)

        return jax.vmap(one)(qr, rr, q_rows, r_rows, nvalid, T0)

    return run


# Largest batched-ICP compile bucket: dispatch_icp_batch never pads past
# this (bigger drains split), so warming these buckets covers every
# possible in-loop shape.
ICP_MAX_BATCH = 16


def warm_icp_batches(params, buckets=(8, 16)):
    """Pre-compile the batched ICP verifier at its batch buckets, so that
    no bucket's first compile lands inside the first closure-heavy drain
    (a warm persistent compile cache makes this a cache load)."""
    cap = int(getattr(params, "icp_correspondence_cap", 512))
    icp_config = gn.GNConfig(
        kernel_max_error=params.icp_maximum_error_kernel,
        min_num_inliers=params.icp_minimum_number_of_inliers,
        max_iterations=50,
    )
    solver = _batched_icp_solver(params.aligner_type, icp_config)
    for B in buckets:
        data = aligners.ICPData(
            p_moving=jnp.zeros((B, cap, 3), jnp.float32),
            p_fixed=jnp.zeros((B, cap, 3), jnp.float32),
            weight=jnp.ones((B, cap), jnp.float32),
        )
        jax.block_until_ready(
            solver(data, jnp.ones((B, cap), bool),
                   jnp.tile(jnp.eye(4), (B, 1, 1)))
        )


class Relocalizer:
    QUERY_CAP = 1024  # fixed query/insert chunk (>= local_map max landmarks)

    def __init__(self, params: RelocalizationParameters, capacity: int = 131072,
                 mesh=None):
        self.params = params
        self.capacity = capacity
        # With a device mesh, queries run row-sharded across all devices
        # (parallel/sharded_search.py) — same results, database-size scaling
        # (the HBST-at-scale replacement, relocalizer.cpp:55-70).
        self.mesh = mesh
        # Optional device keyframe-archive accessor (set by the engine for
        # the fused tracker): () -> (kf_pose (KR,4,4), kf_xyz (KR,K,3),
        # horizon_map_id) — ICP verification then gathers its point sets
        # on device instead of uploading host xyz blocks.
        self.ring_provider = None
        # Device-resident database (fixed capacity, appended in place).
        # db_map_id is the FIRST-insertion local map of each row (-1 empty);
        # it doubles as the validity mask and the interspace gate.
        self.db_desc = jnp.zeros((capacity, 8), jnp.uint32)
        self.db_map_id = jnp.full(capacity, -1, jnp.int32)
        # Host-side row metadata.
        self.row_slot = np.full(capacity, -1, np.int32)
        self.n_rows = 0
        self.maps: dict[int, LocalMap] = {}
        # landmark slot -> every local map containing it (drives voting).
        self._slot_maps: dict[int, list[int]] = {}
        self._slot_in_db: set[int] = set()
        # Lazy per-map slot->row index caches for ICP correspondence lookup.
        self._map_slot_row: dict[int, dict[int, int]] = {}

    # ------------------------------------------------------------------
    def _active_prefix(self) -> int:
        """Power-of-two bucket covering the live database rows (>= 1024 so
        the query programs compile O(log rows) times, not per keyframe)."""
        n = max(self.n_rows, 1)
        return min(1 << max((n - 1).bit_length(), 10), self.capacity)

    def _grow(self):
        """Double the device database (power-of-two growth: the query and
        insert programs recompile only O(log maps) times over a run —
        replaces the round-1 silent 128-local-map cap)."""
        from vslam_tpu.utils import log

        new_cap = self.capacity * 2
        log.warning(
            f"relocalizer database full at {self.n_rows} rows — growing "
            f"to {new_cap}"
        )
        db_desc = jnp.zeros((new_cap, 8), jnp.uint32)
        db_map_id = jnp.full(new_cap, -1, jnp.int32)
        self.db_desc = jax.lax.dynamic_update_slice(db_desc, self.db_desc, (0, 0))
        self.db_map_id = jax.lax.dynamic_update_slice(
            db_map_id, self.db_map_id, (0,)
        )
        row_slot = np.full(new_cap, -1, np.int32)
        row_slot[: self.capacity] = self.row_slot
        self.row_slot = row_slot
        self.capacity = new_cap

    def _stage_chunk(self, lm: LocalMap):
        """Host-side prep shared by submit/add: dedup fresh rows, register
        membership, reserve row metadata.  Returns (q_desc (QUERY_CAP, 8),
        fresh_mask (QUERY_CAP,), nq, offset).

        q_desc is a host numpy block when the local map carries host
        descriptors, or the DEVICE-resident padded block (lm.desc_dev,
        fused.gather_kf_desc) when they never left the device — the fused
        query/insert programs accept either (rows beyond nq may then hold
        stale ring data: they are never fresh and their query results are
        ignored by vote())."""
        nq = min(len(lm.landmark_slots), self.QUERY_CAP)
        self.maps[lm.map_id] = lm
        fresh = np.zeros(self.QUERY_CAP, bool)
        slots = np.asarray(lm.landmark_slots[:nq])
        for i in range(nq):
            s = int(slots[i])
            self._slot_maps.setdefault(s, []).append(lm.map_id)
            if s not in self._slot_in_db:
                fresh[i] = True
                self._slot_in_db.add(s)
        k = int(fresh.sum())
        while self.n_rows + k > self.capacity:
            self._grow()
        if lm.desc is None:
            assert lm.desc_dev is not None, (
                f"local map {lm.map_id}: no host descriptors and no "
                "device-side block (engine must attach desc_dev for "
                "ring-backed snapshots)"
            )
            q_desc = lm.desc_dev
        else:
            q_desc = np.zeros((self.QUERY_CAP, 8), np.uint32)
            q_desc[:nq] = lm.desc[:nq]
        offset = self.n_rows
        sel = np.flatnonzero(fresh)
        self.row_slot[offset : offset + k] = slots[sel]
        self.n_rows += k
        return q_desc, fresh, nq, offset

    def add_local_map(self, lm: LocalMap) -> None:
        """Insert a local map's fresh landmark rows (no query)."""
        q_desc, fresh, nq, offset = self._stage_chunk(lm)
        if not fresh.any():
            return
        self.db_desc, self.db_map_id = _insert_only(
            self.db_desc, self.db_map_id,
            jnp.asarray(q_desc), jnp.asarray(fresh),
            jnp.int32(offset), jnp.int32(lm.map_id),
        )

    # ------------------------------------------------------------------
    def submit(self, lm: LocalMap) -> QueryHandle | None:
        """Dispatch the fused query+insert program for a new local map.

        Returns a QueryHandle to pass to resolve() later (NO device sync
        happens here), or None when the database has nothing eligible yet.
        """
        p = self.params
        max_map_id = lm.map_id - p.preliminary_minimum_interspace_queries
        prefix = self._active_prefix()
        q_desc, fresh, nq, offset = self._stage_chunk(lm)
        q_dev = jnp.asarray(q_desc)
        fresh_dev = jnp.asarray(fresh)
        if self.mesh is not None and self.capacity % self.mesh.size == 0 and (
            self.capacity <= (1 << 22)  # packed-index limit
        ):
            from vslam_tpu.parallel import sharded_search

            valid_rows = _eligibility(self.db_map_id, jnp.int32(max_map_id))
            idx, best_d, second_d = sharded_search.search_sharded_top2(
                q_dev, self.db_desc, valid_rows, self.mesh,
                axis_name=self.mesh.axis_names[0],
            )
            ok = (best_d <= p.maximum_descriptor_distance) & (
                second_d - best_d >= p.minimum_second_best_margin
            )
            self.db_desc, self.db_map_id = _insert_only(
                self.db_desc, self.db_map_id, q_dev, fresh_dev,
                jnp.int32(offset), jnp.int32(lm.map_id),
            )
        else:
            idx, ok, _, self.db_desc, self.db_map_id = _query_and_insert(
                q_dev, fresh_dev, self.db_desc, self.db_map_id,
                jnp.int32(offset), jnp.int32(lm.map_id),
                jnp.int32(max_map_id),
                jnp.int32(p.maximum_descriptor_distance),
                jnp.int32(p.minimum_second_best_margin),
                prefix,
            )
        if max_map_id < 0 or nq == 0:
            return None
        return QueryHandle(query=lm, nq=nq, idx_dev=idx, ok_dev=ok)

    def submit_batch(self, lms: list[LocalMap]) -> list[QueryHandle | None]:
        """Dispatch query+insert for several new local maps as ONE device
        program (see _query_and_insert_many).  Falls back to per-map
        submit() on the sharded-search path.  Batches larger than the
        interspace gate are split so within-batch maps stay mutually
        ineligible (sequential-path equivalence)."""
        p = self.params
        interspace = max(int(p.preliminary_minimum_interspace_queries), 1)
        if self.mesh is not None or len(lms) == 1:
            return [self.submit(lm) for lm in lms]
        if len(lms) > interspace:
            out = []
            for i in range(0, len(lms), interspace):
                out.extend(self.submit_batch(lms[i : i + interspace]))
            return out
        from vslam_tpu.utils import log

        S = len(lms)
        # _query_and_insert_many is exact w.r.t. the sequential path ONLY
        # for S <= interspace (within-batch maps must stay mutually
        # ineligible; the fused program queries pre-insert db state).
        # The split above guarantees it — assert so a future cadence
        # change cannot silently alter closure semantics (VERDICT r4 #8).
        assert S <= interspace, (
            f"relocalizer batch of {S} maps exceeds interspace "
            f"{interspace}: fused query+insert would see within-batch rows"
        )
        CAP = self.QUERY_CAP
        prefix = self._active_prefix()  # pre-insert rows (queries see these)
        with log.measure("reloc_stage"):
            staged = [self._stage_chunk(lm) for lm in lms]
        SB = 1 << max(S - 1, 0).bit_length()  # pad S to a compile bucket
        dest = np.full(SB * CAP, -1, np.int32)
        row_mid = np.zeros(SB * CAP, np.int32)
        maxm = np.full(SB, -1, np.int32)
        for i, (lm, (q_desc, fresh, nq, offset)) in enumerate(zip(lms, staged)):
            sel = np.flatnonzero(fresh)
            dest[i * CAP + sel] = offset + np.arange(len(sel))
            row_mid[i * CAP + sel] = lm.map_id
            maxm[i] = lm.map_id - p.preliminary_minimum_interspace_queries
        # Assemble the query stack where the blocks live: device-resident
        # blocks (desc_dev) concatenate on device with no host transfer;
        # host blocks upload (32 KB each).
        parts = [jnp.asarray(st[0])[None] for st in staged]
        if SB > S:
            parts.append(jnp.zeros((SB - S, CAP, 8), jnp.uint32))
        q = jnp.concatenate(parts, axis=0)
        with log.measure("reloc_dispatch"):
            best, ok, self.db_desc, self.db_map_id = _query_and_insert_many(
                q, jnp.asarray(dest), jnp.asarray(row_mid),
                self.db_desc, self.db_map_id, jnp.asarray(maxm),
                jnp.int32(p.maximum_descriptor_distance),
                jnp.int32(p.minimum_second_best_margin),
                prefix,
            )
        handles: list[QueryHandle | None] = []
        for i, (lm, (q_desc, fresh, nq, offset)) in enumerate(zip(lms, staged)):
            if maxm[i] < 0 or nq == 0:
                handles.append(None)
            else:
                handles.append(
                    QueryHandle(query=lm, nq=nq, idx_dev=best[i], ok_dev=ok[i])
                )
        return handles

    def resolve_all(self, handles) -> list[Closure | None]:
        """Resolve a batch of in-flight queries with ONE device->host
        transfer instead of one sync per query."""
        from vslam_tpu.utils import log

        live = [h for h in handles if h is not None]
        if live:
            with log.measure("reloc_get"):
                fetched = jax.device_get([(h.idx_dev, h.ok_dev) for h in live])
            for h, (idx, ok) in zip(live, fetched):
                h.idx_dev, h.ok_dev = idx, ok
        with log.measure("reloc_vote_icp"):
            return [self.resolve(h) for h in handles]

    def resolve(self, handle: QueryHandle | None) -> Closure | None:
        """Read an in-flight query's result; vote per reference map; verify
        the winning candidate with robust point-to-point ICP (synchronous
        composition of vote_and_dispatch_icp + finish_icp)."""
        job = self.vote_and_dispatch_icp(handle)
        if job is None:
            return None
        return self.finish_icp(job, self.job_result(job))

    @staticmethod
    def job_result(job):
        """Host result slice for one ICP job; fetches (and caches) its
        batch's device result on first use."""
        if job.batch.fetched is None:
            job.batch.fetched = jax.device_get(job.batch.res_dev)
        return jax.tree.map(lambda a: a[job.index], job.batch.fetched)

    def vote_and_dispatch_icp(self, handle: QueryHandle | None):
        """Single-candidate compatibility wrapper: vote + one-element
        dispatch_icp_batch (the pipelined engine batches all of a drain's
        candidates instead)."""
        jobs = self.dispatch_icp_batch([self.vote(handle)])
        return jobs[0] if jobs else None

    def vote(self, handle: QueryHandle | None):
        """Pipelined resolve, phase 1: vote per reference map on the
        (already fetched) query result and build correspondences for the
        winning candidate — pure host work, no device interaction.
        Returns an ICPCandidate for dispatch_icp_batch, or None if no
        candidate cleared the vote gate."""
        if handle is None:
            return None
        p = self.params
        lm = handle.query
        nq = handle.nq
        idx = np.asarray(handle.idx_dev)[:nq]
        ok = np.asarray(handle.ok_dev)[:nq]
        if not ok.any():
            return None
        max_map_id = lm.map_id - p.preliminary_minimum_interspace_queries

        # Vote: each matched row votes for EVERY eligible map containing
        # its landmark (merged-matchable semantics, relocalizer.cpp:86-123).
        # Vectorized tally (bincount over the flattened membership lists) —
        # the per-row dict loop was O(rows x memberships) Python at scale.
        from itertools import chain

        q_rows_all = np.flatnonzero(ok)
        matched_slots = self.row_slot[idx[q_rows_all]]
        mids = np.fromiter(
            chain.from_iterable(
                self._slot_maps.get(int(s), ()) for s in matched_slots
            ),
            np.int64,
        )
        mids = mids[mids <= max_map_id]
        if len(mids) == 0:
            return None
        # Ambiguity gate (reference relocalizer.cpp:126): the query must
        # have matched at least this many DISTINCT landmarks before any
        # candidate is considered.
        if (
            len(np.unique(matched_slots))
            < p.minimum_number_of_matches_per_landmark
        ):
            return None
        counts = np.bincount(mids)
        best_map = int(np.argmax(counts))
        n_votes = int(counts[best_map])
        ratio = n_votes / nq
        if (
            ratio < p.preliminary_minimum_matching_ratio
            or n_votes < p.icp_minimum_number_of_inliers
        ):
            from vslam_tpu.utils import log

            log.debug(
                f"closure candidate {best_map}<-{lm.map_id}: vote gate "
                f"failed ({n_votes} votes, ratio {ratio:.3f})"
            )
            return None

        # Correspondences into the winning map (positions in ITS keyframe
        # frame — membership voting means the matched row's first-insertion
        # map may differ from the winner).
        ref = self.maps[best_map]
        slot_row = self._map_slot_row.get(best_map)
        if slot_row is None:
            slot_row = {
                int(s): j for j, s in enumerate(ref.landmark_slots)
            }
            self._map_slot_row[best_map] = slot_row
        pairs = [
            (int(q), slot_row[int(s)])
            for q, s in zip(q_rows_all, matched_slots)
            if int(s) in slot_row
        ]
        # Per-correspondence support gate (reference relocalizer.cpp:267,
        # count_best > minimum_matches_per_correspondence).  Top-1 Hamming
        # matching gives every pair support exactly 1, so thresholds 0/1
        # keep all pairs (every shipped reference config uses 0 or 1) and
        # >=2 disables correspondence formation — documented deviation
        # from the reference's multi-match counting.
        if p.minimum_matches_per_correspondence >= 2:
            pairs = []
        if len(pairs) < p.icp_minimum_number_of_inliers:
            return None
        q_rows = np.asarray([a for a, _ in pairs])
        r_rows = np.asarray([b for _, b in pairs])
        cap = int(getattr(p, "icp_correspondence_cap", 512))
        return ICPCandidate(
            query=lm,
            reference=ref,
            q_rows=q_rows,
            r_rows=r_rows,
            n=min(len(pairs), cap),
        )

    def dispatch_icp_batch(self, candidates) -> list:
        """Geometric verification for ALL of a drain's vote survivors in
        one batch: one stacked host->device upload + one vmapped robust
        point-to-point ICP program.  A per-candidate upload serializes
        behind the in-flight frame chunk; batching pays that wait once per
        drain.

        Returns ICPJobs whose res_dev are device-sliced per-candidate
        results (no extra uploads).  The reference verifies candidates
        one by one with its XYZ/FAST-ICP aligner (relocalizer.cpp:
        177-188); the batched program computes the identical solves.
        """
        candidates = [c for c in candidates if c is not None]
        if not candidates:
            return []
        # Clamp the batch to the largest warmed compile bucket: a drain
        # with more vote survivors than ICP_MAX_BATCH must not trigger an
        # unwarmed in-loop compile — the overflow verifies in further
        # batches instead.
        if len(candidates) > ICP_MAX_BATCH:
            out = []
            for i in range(0, len(candidates), ICP_MAX_BATCH):
                out.extend(
                    self.dispatch_icp_batch(candidates[i : i + ICP_MAX_BATCH])
                )
            return out
        p = self.params
        cap = int(getattr(p, "icp_correspondence_cap", 512))
        B = len(candidates)
        Bp = 1 << max(int(np.ceil(np.log2(B))), 3)  # pow2 bucket, floor 8
        T0 = np.tile(np.eye(4, dtype=np.float32), (Bp, 1, 1))
        for i, c in enumerate(candidates):
            # Initial guess = the CURRENT (drift-carrying) relative
            # keyframe pose, as the reference seeds its closure aligners
            # from the world pose estimates (xyz_aligner.cpp:13-40).
            T0[i] = np.linalg.inv(c.reference.T_world_kf) @ c.query.T_world_kf
        icp_config = gn.GNConfig(
            kernel_max_error=p.icp_maximum_error_kernel,
            min_num_inliers=p.icp_minimum_number_of_inliers,
            max_iterations=50,
        )
        ring = self.ring_provider() if self.ring_provider else None
        archive_ok = ring is not None and all(
            c.query.ring_row >= 0
            and c.reference.ring_row >= 0
            and c.query.map_id > ring[2]
            and c.reference.map_id > ring[2]
            for c in candidates
        )
        if archive_ok:
            kf_pose, kf_xyz, _horizon = ring
            qr = np.zeros(Bp, np.int32)
            rr = np.zeros(Bp, np.int32)
            q_rows = np.zeros((Bp, cap), np.int32)
            r_rows = np.zeros((Bp, cap), np.int32)
            nv = np.zeros(Bp, np.int32)
            for i, c in enumerate(candidates):
                n = c.n
                qr[i] = c.query.ring_row
                rr[i] = c.reference.ring_row
                q_rows[i, :n] = c.q_rows[:n]
                r_rows[i, :n] = c.r_rows[:n]
                nv[i] = n
            batch_res = _batched_icp_from_archive(p.aligner_type, icp_config)(
                kf_pose, kf_xyz, jnp.asarray(qr), jnp.asarray(rr),
                jnp.asarray(q_rows), jnp.asarray(r_rows), jnp.asarray(nv),
                jnp.asarray(T0),
            )
        else:
            mov = np.zeros((Bp, cap, 3), np.float32)
            fix = np.zeros((Bp, cap, 3), np.float32)
            msk = np.zeros((Bp, cap), bool)
            for i, c in enumerate(candidates):
                lm, ref = c.query, c.reference
                n = c.n
                mov[i, :n] = lm.xyz_kf[c.q_rows[:n]]
                fix[i, :n] = ref.xyz_kf[c.r_rows[:n]]
                msk[i, :n] = True
            data = aligners.ICPData(
                p_moving=jnp.asarray(mov),
                p_fixed=jnp.asarray(fix),
                weight=jnp.ones((Bp, cap), jnp.float32),
            )
            # Fork's AA-ICP (fast_aligner.cpp) is selected exactly like the
            # reference (relocalizer.cpp:19-27); both aligners run as ONE
            # compiled vmapped program per batch bucket.
            batch_res = _batched_icp_solver(p.aligner_type, icp_config)(
                data, jnp.asarray(msk), jnp.asarray(T0)
            )
        batch = ICPBatch(res_dev=batch_res)
        return [
            ICPJob(
                query=c.query,
                reference=c.reference,
                q_rows=c.q_rows,
                r_rows=c.r_rows,
                n=c.n,
                batch=batch,
                index=i,
            )
            for i, c in enumerate(candidates)
        ]

    def finish_icp(self, job, res) -> Closure | None:
        """Pipelined resolve, phase 2: gate a fetched ICP result and emit
        the Closure (geometric-verification acceptance,
        xyz_aligner.cpp:106-177)."""
        p = self.params
        lm, ref = job.query, job.reference
        n_inl = int(res.num_inliers)
        inlier_ratio = n_inl / max(job.n, 1)
        if (
            not bool(res.converged)
            or n_inl < p.icp_minimum_number_of_inliers
            or inlier_ratio < p.icp_minimum_inlier_ratio
        ):
            from vslam_tpu.utils import log

            log.debug(
                f"closure candidate {ref.map_id}<-{lm.map_id}: ICP rejected "
                f"(converged={bool(res.converged)}, inliers={n_inl}/"
                f"{job.n}, chi2={float(res.chi2):.3f})"
            )
            return None

        q_slots = np.asarray(lm.landmark_slots)[job.q_rows]
        r_slots = np.asarray(ref.landmark_slots)[job.r_rows]
        keep = q_slots != r_slots  # identical slots merge to a no-op
        corr = np.stack([q_slots[keep], r_slots[keep]], axis=1)
        return Closure(
            query_id=lm.map_id,
            reference_id=ref.map_id,
            T_ref_query=np.asarray(res.x),
            n_correspondences=job.n,
            inlier_ratio=inlier_ratio,
            correspondences=corr.astype(np.int32),
        )

    # ------------------------------------------------------------------
    def detect_and_verify(self, query: LocalMap) -> Closure | None:
        """Synchronous query WITHOUT inserting `query` into the database
        (back-compat surface; the engine uses submit()/resolve()).

        Returns a Closure or None."""
        p = self.params
        if self.n_rows == 0 or len(query.landmark_slots) == 0:
            return None
        max_map_id = query.map_id - p.preliminary_minimum_interspace_queries
        if max_map_id < 0:
            return None
        nq = min(len(query.landmark_slots), self.QUERY_CAP)
        if query.desc is None:  # device-resident block (slim-drain mode)
            q_desc = np.asarray(query.desc_dev)
        else:
            q_desc = np.zeros((self.QUERY_CAP, 8), np.uint32)
            q_desc[:nq] = query.desc[:nq]
        if (
            self.mesh is not None
            and self.capacity % self.mesh.size == 0
            and self.capacity <= (1 << 22)  # packed-index limit
        ):
            from vslam_tpu.parallel import sharded_search

            valid_rows = _eligibility(self.db_map_id, jnp.int32(max_map_id))
            idx, best_d, second_d = sharded_search.search_sharded_top2(
                jnp.asarray(q_desc), self.db_desc, valid_rows, self.mesh,
                axis_name=self.mesh.axis_names[0],
            )
            ok = (best_d <= p.maximum_descriptor_distance) & (
                second_d - best_d >= p.minimum_second_best_margin
            )
        else:
            idx, ok, _ = _query_database(
                jnp.asarray(q_desc),
                self.db_desc,
                self.db_map_id,
                jnp.int32(max_map_id),
                jnp.int32(p.maximum_descriptor_distance),
                jnp.int32(p.minimum_second_best_margin),
            )
        return self.resolve(
            QueryHandle(query=query, nq=nq, idx_dev=idx, ok_dev=ok)
        )

    # ------------------------------------------------------------------
    def apply_remap(self, remap: dict[int, int], lut=None) -> None:
        """Follow landmark merges: database rows referencing an absorbed
        slot now reference its representative (reference LocalMap::replace
        keeps local maps consistent after merging, local_map.cpp:109-127).
        lut: optional precomputed slot lookup (arange with remapped
        entries) — one vectorized pass instead of a per-pair scan."""
        if not remap or self.n_rows == 0:
            return
        rows = self.row_slot[: self.n_rows]
        if lut is not None and len(lut) > int(rows.max(initial=0)):
            valid = rows >= 0
            rows[valid] = lut[rows[valid]]
        else:
            for src, dst in remap.items():
                rows[rows == src] = dst
        for src, dst in remap.items():
            if src in self._slot_in_db:
                self._slot_in_db.discard(src)
                self._slot_in_db.add(dst)
            if src in self._slot_maps:
                dst_maps = self._slot_maps.setdefault(dst, [])
                dst_maps.extend(
                    m for m in self._slot_maps.pop(src) if m not in dst_maps
                )
        # Per-map slot->row caches hold pre-merge slots; rebuild lazily.
        self._map_slot_row.clear()
