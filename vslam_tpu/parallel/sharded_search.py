"""Sharded loop-closure descriptor search.

Replaces the reference's HBST tree (relocalizer.cpp:55-70) at scale: the
keyframe descriptor database lives row-sharded across the "lm" mesh axis;
a query block is replicated, each shard computes its slice of the
XOR-popcount (or int8-matmul) distance matrix and its local top-1 per
query, and one psum-style min-reduction combines the per-shard winners.
Communication: O(Q) scalars — independent of database size.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from vslam_tpu.ops import hamming


def search_sharded(
    query: jnp.ndarray,  # (Q, 8) uint32
    db: jnp.ndarray,  # (D, 8) uint32, D divisible by mesh size
    db_valid: jnp.ndarray,  # (D,) bool
    mesh: Mesh,
    axis_name: str = "lm",
    use_mxu: bool = True,
):
    """Global nearest descriptor per query.  Returns (best_idx (Q,) int32
    into the full db, best_dist (Q,) int32)."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis_name), P(axis_name)),
        out_specs=(P(), P()),
    )
    def run(q, db_shard, valid_shard):
        if use_mxu:
            dist = hamming.hamming_matrix_mxu(q, db_shard)
        else:
            dist = hamming.hamming_matrix(q, db_shard)
        best_f, local_idx = hamming.min_encode(dist, valid_shard[None, :],
                                               axis=1)
        local_best = best_f.astype(jnp.int32)
        shard_size = db_shard.shape[0]
        my_shard = jax.lax.axis_index(axis_name)
        global_idx = local_idx + my_shard * shard_size
        # Min-reduce (dist, idx) lexicographically across shards: distances
        # are <= 256, masked sentinel 511 (9 bits), so pack dist<<22 | idx
        # into int32 (db size up to 2^22 rows) and take one integer pmin.
        # Shift 22 is the largest that keeps 511<<22 | idx <= INT32_MAX —
        # shift 23 overflows for the sentinel and corrupts the reduction.
        d9 = jnp.minimum(local_best, 511)
        packed = (d9 << 22) | global_idx
        packed = jax.lax.pmin(packed, axis_name)
        best_dist = (packed >> 22).astype(jnp.int32)
        best_idx = (packed & ((1 << 22) - 1)).astype(jnp.int32)
        return best_idx, best_dist

    return run(query, db, db_valid)


def search_sharded_top2(
    query: jnp.ndarray,  # (Q, 8) uint32
    db: jnp.ndarray,  # (D, 8) uint32, D divisible by mesh size
    db_valid: jnp.ndarray,  # (D,) bool
    mesh: Mesh,
    axis_name: str = "lm",
):
    """Global best AND second-best distances per query (the Lowe-margin
    variant the live Relocalizer needs).  Two integer pmin reductions:
    the packed (dist, idx) winner, then the best distance EXCLUDING the
    winner's row (a shard whose local best is the global winner contributes
    its local runner-up instead).

    Returns (best_idx (Q,), best_dist (Q,), second_dist (Q,)) int32.
    """

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis_name), P(axis_name)),
        out_specs=(P(), P(), P()),
    )
    def run(q, db_shard, valid_shard):
        dist = hamming.hamming_matrix_mxu(q, db_shard)
        # Local (best, runner-up) via two min-encode passes — top_k lowers
        # to a full per-row sort (see ops/hamming.min_encode).
        d1_f, l1 = hamming.min_encode(dist, valid_shard[None, :], axis=1)
        cols = jax.lax.broadcasted_iota(jnp.int32, dist.shape, 1)
        mask2 = valid_shard[None, :] & (cols != l1[:, None])
        d2_f, _ = hamming.min_encode(dist, mask2, axis=1)
        d1 = jnp.minimum(d1_f.astype(jnp.int32), 511)
        d2 = jnp.minimum(d2_f.astype(jnp.int32), 511)
        shard_size = db_shard.shape[0]
        my_shard = jax.lax.axis_index(axis_name)
        g1 = l1 + my_shard * shard_size

        # Shift 22: 511 (masked sentinel) << 22 | idx fits int32 exactly;
        # shift 23 would overflow and corrupt the pmin (cf. search_sharded).
        packed = jax.lax.pmin((d1 << 22) | g1, axis_name)
        best_dist = (packed >> 22).astype(jnp.int32)
        best_idx = (packed & ((1 << 22) - 1)).astype(jnp.int32)
        # Runner-up: my d1 unless my local winner IS the global winner.
        alt = jnp.where(g1 == best_idx, d2, d1)
        second_dist = jax.lax.pmin(alt, axis_name).astype(jnp.int32)
        return best_idx, best_dist, second_dist

    return run(query, db, db_valid)
