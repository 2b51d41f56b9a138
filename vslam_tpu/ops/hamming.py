"""Packed binary-descriptor algebra: the universal matching primitive.

Descriptors are 256-bit binary strings packed as uint32[8] words
(reference: SRRG_PROSLAM_DESCRIPTOR_SIZE_BITS=256, definitions.h:44-49).
Hamming distance = popcount(a XOR b).  This one kernel family replaces the
reference's three separate matchers:
  - stereo epipolar sweep      (stereo_framepoint_generator.cpp:278-426)
  - windowed projective search (intensity_feature_matcher.cpp:81-148)
  - HBST loop-closure tree     (relocalizer.cpp:55-70)

Two codepaths, both exact:
  * popcount path — jax.lax.population_count on the XOR of word pairs;
    cheap elementwise work for frame-sized sets (K ~ 1k).
  * matmul path — unpack bits to int8 in {0,1}; dist = r_q + r_db - 2 q.db
    via an int8 matmul with int32 accumulation (a library integer GEMM);
    used for the large sharded loop-closure database where the problem is
    genuinely matmul-shaped.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DESC_BITS = 256
DESC_WORDS = DESC_BITS // 32
BIG = jnp.int32(1 << 20)  # sentinel distance for masked-out pairs


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """(N, 256) {0,1} -> (N, 8) uint32, little-endian bit order per word."""
    bits = bits.astype(jnp.uint32).reshape(bits.shape[0], DESC_WORDS, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(bits << shifts, axis=-1).astype(jnp.uint32)


def unpack_bits(desc: jnp.ndarray) -> jnp.ndarray:
    """(N, 8) uint32 -> (N, 256) uint8 in {0,1}."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(desc.shape[0], DESC_BITS).astype(jnp.uint8)


def hamming_pairwise(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Elementwise distance between aligned rows: (N,8),(N,8) -> (N,) int32."""
    x = jnp.bitwise_xor(a, b)
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def hamming_matrix(q: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """Full distance matrix (Q, 8) x (D, 8) -> (Q, D) int32 via popcount.

    Memory: Q*D*8 uint32 intermediates; fine for frame-sized sets.
    """
    x = jnp.bitwise_xor(q[:, None, :], db[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def hamming_matrix_mxu(q: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """Distance matrix via int8 matmul for large databases.

    d(a,b) = popcount(a) + popcount(b) - 2 * <bits_a, bits_b>.
    The inner product of {0,1} bit vectors is an (Q,256)x(256,D) int8
    matmul accumulated in int32, so the result equals hamming_matrix
    exactly — the "descriptor matmul" design from SURVEY.md §2.5.
    """
    qb = unpack_bits(q).astype(jnp.int8)
    dbb = unpack_bits(db).astype(jnp.int8)
    inner = jax.lax.dot_general(
        qb,
        dbb,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    rq = jnp.sum(qb.astype(jnp.int32), axis=1)
    rdb = jnp.sum(dbb.astype(jnp.int32), axis=1)
    return rq[:, None] + rdb[None, :] - 2 * inner


def min_encode(dist, mask, axis):
    """Fused (min, argmin) via a single int32 min reduction.

    Encoding the index into the value — enc = d * N + i with d <= SENT —
    turns (min, argmin) into one plain min reduction instead of a
    variadic (value, index) reduce.  d * N + i stays within
    int32 for N up to 2^31 / SENT ≈ 4.1M rows (asserted at trace time).
    Returns (best_dist f32, best_idx int32) along `axis`.
    """
    n = dist.shape[axis]
    sent = jnp.int32(512)  # > max Hamming distance (256) for any mask-out
    assert 512 * (n + 1) < (1 << 31), "index capacity overflows int32 encode"
    d = jnp.where(mask, jnp.minimum(dist.astype(jnp.int32), sent), sent)
    idx = jax.lax.broadcasted_iota(jnp.int32, dist.shape, axis)
    enc = jnp.min(d * n + idx, axis=axis)
    best = enc // n
    best_idx = enc - best * n
    return best.astype(jnp.float32), best_idx


def masked_argmin(
    dist: jnp.ndarray,
    mask: jnp.ndarray,
    max_distance: jnp.ndarray | int,
):
    """Per-row best match under a pair mask and a distance gate.

    Returns (best_idx (Q,), best_dist (Q,), valid (Q,)). Invalid rows get
    idx 0 and dist BIG; callers must respect `valid`.
    """
    best, best_idx = min_encode(dist, mask, axis=1)
    valid = best <= max_distance
    best_out = jnp.where(valid, best, jnp.float32(BIG)).astype(dist.dtype)
    return jnp.where(valid, best_idx, 0), best_out, valid


def mutual_best_match(
    dist: jnp.ndarray,
    mask: jnp.ndarray,
    max_distance: jnp.ndarray | int,
):
    """One-to-one assignment by mutual-best cross-check.

    The reference's greedy row-scan consumes features sequentially
    (stereo_framepoint_generator.cpp:398-415) — order-dependent and serial.
    The parallel equivalent: q matches d iff each is the other's argmin and
    the distance passes the gate.  Returns (match_idx (Q,), valid (Q,),
    best_dist (Q,)).
    """
    best, best_j = min_encode(dist, mask, axis=1)  # per query
    _, best_i = min_encode(dist, mask, axis=0)  # per db row
    q_ids = jnp.arange(dist.shape[0], dtype=jnp.int32)
    mutual = jnp.take(best_i, best_j) == q_ids
    valid = mutual & (best <= max_distance)
    return best_j, valid, best.astype(dist.dtype)
