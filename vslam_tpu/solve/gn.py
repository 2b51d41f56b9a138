"""The generic robust Gauss-Newton engine.

One engine, instantiated four ways (SURVEY.md §7.1), collapsing the
reference's aligner class hierarchy (src/aligners/base_aligner.h:7-106 and
its four subclasses) plus the per-landmark refinement
(src/types/landmark.cpp:66-167) into a single functional component:

    x* = argmin_x  sum_i  rho( r_i(x)^T Omega_i r_i(x) )

- residuals are vmapped over measurements (the reference's serial
  per-point `linearize` loops become one batched Jacobian evaluation);
- H = J^T Omega J and b = J^T Omega r are einsum reductions (matmul-shaped);
- the robust kernel is the reference's error-clamping reweighting
  (omega *= kernel/chi2 beyond the threshold, stereouv_aligner.cpp:127-134);
- iteration runs under lax.while_loop with damping, so the whole solve is
  one XLA program with no host round-trips.

State updates are pluggable (manifold retraction for SE(3), plain addition
for Euclidean landmark positions).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from vslam_tpu.ops import lie


class GNConfig(NamedTuple):
    """Mirrors reference AlignerParameters (src/types/parameters.h:66-95)."""

    max_iterations: int = 30
    kernel_max_error: float = 25.0  # chi2 threshold for robust reweighting
    damping: float = 1.0
    min_num_inliers: int = 10
    tolerance: float = 1e-4  # stop when |delta chi2| / chi2 below this
    step_tolerance: float = 1e-3  # ...AND the GN step norm is below this
    # Inlier-only refinement rounds (converge()): each while-loop round
    # is serial latency, and the solve is re-entered every frame — 4
    # rounds covers the post-outlier-rejection
    # correction the reference's inlier phase does (it too breaks on the
    # first sub-tolerance round, stereouv_aligner.cpp:225-236).
    refine_iterations: int = 4
    max_step_norm: float = 1.0  # trust-region clamp on |dx| per round


class GNResult(NamedTuple):
    x: jnp.ndarray  # final state
    chi2: jnp.ndarray  # mean inlier chi2
    num_inliers: jnp.ndarray  # int32
    num_iterations: jnp.ndarray  # int32
    inlier_mask: jnp.ndarray  # (N,) bool over measurements
    converged: jnp.ndarray  # bool


def _robust_weights(chi2: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """Reference-style clamping kernel: weight = kernel/chi2 beyond it."""
    return jnp.where(chi2 > kernel, kernel / jnp.maximum(chi2, 1e-12), 1.0)


def inv3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 3x3 inverse via the adjugate — pure elementwise ops.

    For the 3x3/6x6 systems of this codebase closed forms are exact,
    need no factorization library call, and vmap cleanly.
    """
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / det
    adj = jnp.stack([
        co_a, c * h - b * i, b * f - c * e,
        co_b, a * i - c * g, c * d - a * f,
        co_c, b * g - a * h, a * e - b * d,
    ], axis=-1).reshape(A.shape)
    return adj * inv_det[..., None, None]


def inv6(M: jnp.ndarray) -> jnp.ndarray:
    """Closed-form SPD 6x6 inverse via 2x2-block Schur complement of 3x3
    blocks (each inverted by the closed-form adjugate) — pure vectorized
    ops, batchable over leading dims; same rationale as inv3."""
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    C = M[..., 3:, 3:]
    Ai = inv3(A)
    AiB = jnp.einsum("...ij,...jk->...ik", Ai, B)
    S = C - jnp.einsum("...ji,...jk->...ik", B, AiB)
    Si = inv3(S)
    AiB_Si = jnp.einsum("...ij,...jk->...ik", AiB, Si)
    TL = Ai + jnp.einsum("...ij,...kj->...ik", AiB_Si, AiB)
    TR = -AiB_Si
    BL = jnp.swapaxes(TR, -1, -2)
    return jnp.concatenate([
        jnp.concatenate([TL, TR], axis=-1),
        jnp.concatenate([BL, Si], axis=-1),
    ], axis=-2)


def solve_spd(H: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve H x = b for SPD H of static size 3 or 6 with closed forms.

    6x6 goes through one step of block elimination (Schur complement of
    the leading 3x3 block), each block handled by the closed-form 3x3
    inverse.  Falls back to Cholesky for other sizes.
    """
    dim = H.shape[-1]
    if dim == 3:
        return jnp.einsum("...ij,...j->...i", inv3(H), b)
    if dim == 6:
        A = H[..., :3, :3]
        B = H[..., :3, 3:]
        C = H[..., 3:, 3:]
        b1 = b[..., :3]
        b2 = b[..., 3:]
        Ai = inv3(A)
        AiB = jnp.einsum("...ij,...jk->...ik", Ai, B)
        S = C - jnp.einsum("...ji,...jk->...ik", B, AiB)
        Si = inv3(S)
        Aib1 = jnp.einsum("...ij,...j->...i", Ai, b1)
        y = jnp.einsum("...ij,...j->...i",
                       Si, b2 - jnp.einsum("...ji,...j->...i", B, Aib1))
        x = Aib1 - jnp.einsum("...ij,...j->...i", AiB, y)
        return jnp.concatenate([x, y], axis=-1)
    L = jax.scipy.linalg.cho_factor(H, lower=True)
    return jax.scipy.linalg.cho_solve(L, b)


def solve_normal_equations(H: jnp.ndarray, b: jnp.ndarray, damping) -> jnp.ndarray:
    """Damped solve of (H + damping*I) dx = -b (H is SPD+damped)."""
    dim = H.shape[-1]
    Hd = H + damping * jnp.eye(dim, dtype=H.dtype)
    return -solve_spd(Hd, b)


def gauss_newton(
    residual_fn: Callable,
    x0: jnp.ndarray,
    data,
    mask: jnp.ndarray,
    config: GNConfig,
    retract: Callable | None = None,
    diag_fn: Callable | None = None,
    state_dim: int | None = None,
):
    """Run robust GN to convergence, then inlier-only refinement rounds.

    Args:
      residual_fn: (x, datum) -> (r (R,), J (R, D)) for one measurement.
        Vmapped internally over the leading axis of `data`.
      x0: initial state (any array; if `retract` given, a manifold point).
      data: pytree of per-measurement arrays, leading dim N.
      mask: (N,) bool of valid measurements.
      config: GNConfig.
      retract: (x, dx (D,)) -> x.  Defaults to x + dx.
      diag_fn: optional (x, datum, r) -> (R,) per-measurement DIAGONAL
        information (e.g. inverse-depth weighting,
        stereouv_aligner.cpp:57-61).  Defaults to ones.  All four aligner
        instantiations have diagonal Omega, so the engine never
        materializes (N, R, R) matrices.
      state_dim: D; inferred from a probe evaluation if None.

    Returns GNResult. Fully jittable; no data-dependent Python control flow.
    """
    if retract is None:
        retract = lambda x, dx: x + dx

    # Materialize the measurement set BEFORE the iteration loops: without
    # the barrier XLA fuses the (expensive) producer chain — the windowed
    # Hamming match and its gathers in the fused tracker — INTO the
    # while-loop body and recomputes it every GN round.
    data, mask = jax.lax.optimization_barrier((data, mask))

    batched_res = jax.vmap(residual_fn, in_axes=(None, 0))

    def linearize(x, inlier_only_mask):
        r, J = batched_res(x, data)  # (N, R), (N, R, D)
        if diag_fn is not None:
            omega = jax.vmap(diag_fn, in_axes=(None, 0, 0))(x, data, r)
        else:
            omega = jnp.ones_like(r)
        chi2 = jnp.sum(r * omega * r, axis=-1)
        w = _robust_weights(chi2, jnp.asarray(config.kernel_max_error, r.dtype))
        m = (mask & inlier_only_mask).astype(r.dtype)
        w_eff = w * m
        ow = omega * w_eff[:, None]  # (N, R)
        H = jnp.einsum("nri,nr,nrj->ij", J, ow, J)
        b = jnp.einsum("nri,nr->i", J, ow * r)
        inliers = (chi2 <= config.kernel_max_error) & mask & inlier_only_mask
        total_chi2 = jnp.sum(chi2 * w_eff)
        return H, b, total_chi2, inliers, chi2

    def one_round(x, inlier_only_mask):
        H, b, total_chi2, inliers, chi2 = linearize(x, inlier_only_mask)
        dx = solve_normal_equations(H, b, jnp.asarray(config.damping, H.dtype))
        # Trust-region clamp: an unbounded GN step from a bad linearization
        # (e.g. points driven behind the camera) overflows f32 downstream.
        norm = jnp.linalg.norm(dx)
        dx = dx * jnp.minimum(1.0, config.max_step_norm / jnp.maximum(norm, 1e-12))
        x_new = retract(x, dx)
        # Reject non-finite updates outright (singular H under degenerate
        # masks) — keep the previous iterate instead.
        ok = jnp.all(jnp.isfinite(dx))
        x_new = jnp.where(ok, x_new, x)
        return x_new, total_chi2, inliers, jnp.where(ok, norm, 0.0)

    # Phase 1: robust GN over all measurements until chi2 stalls AND the
    # step norm is small.  The chi2 test alone is a trap with the clamping
    # kernel: every outlier contributes exactly `kernel` to the weighted
    # cost, so a far-from-converged solve where ALL residuals exceed the
    # kernel has CONSTANT cost and would stop after 2 rounds even though
    # the IRLS steps are still large (the closure-ICP failure mode).
    def cond(state):
        x, prev_chi2, chi2, it, _, step = state
        rel = jnp.abs(prev_chi2 - chi2) / jnp.maximum(chi2, 1e-12)
        return (it < config.max_iterations) & (
            (it < 2) | (rel > config.tolerance) | (step > config.step_tolerance)
        )

    all_true = jnp.ones_like(mask)

    def body(state):
        x, _, chi2, it, inl, _ = state
        x_new, new_chi2, inliers, step = one_round(x, all_true)
        return (x_new, chi2, new_chi2, it + 1, inliers, step)

    init = (x0, jnp.float32(jnp.inf), jnp.float32(1e30), jnp.int32(0), mask,
            jnp.float32(jnp.inf))
    x, _, chi2, iters, inliers, _ = jax.lax.while_loop(cond, body, init)

    # Phase 2: inlier-only refinement rounds with the same chi2-delta early
    # exit as phase 1 (reference `converge` breaks the inlier loop on
    # convergence too, stereouv_aligner.cpp:225-236 — a fixed round count
    # would spend while-loop rounds after the typical 2-3 rounds have
    # converged).
    def refine_cond(state):
        _, prev_chi2, chi2, it, _, step = state
        rel = jnp.abs(prev_chi2 - chi2) / jnp.maximum(chi2, 1e-12)
        return (it < config.refine_iterations) & (
            (it < 1) | (rel > config.tolerance) | (step > config.step_tolerance)
        )

    def refine_body(state):
        x, _, chi2, it, inliers, _ = state
        x_new, new_chi2, new_inl, step = one_round(x, inliers)
        # Reject a refinement round that collapses the inlier set
        # (reference keeps the previous estimate in that case).
        keep = jnp.sum(new_inl) >= config.min_num_inliers
        return (
            jnp.where(keep, x_new, x),
            chi2,
            jnp.where(keep, new_chi2, chi2),
            it + 1,
            jnp.where(keep, new_inl, inliers),
            jnp.where(keep, step, 0.0),
        )

    refine_init = (x, jnp.float32(jnp.inf), chi2, jnp.int32(0), inliers,
                   jnp.float32(jnp.inf))
    x, _, _, _, inliers, _ = jax.lax.while_loop(
        refine_cond, refine_body, refine_init
    )

    num_inliers = jnp.sum(inliers).astype(jnp.int32)
    # Final statistics on inliers only.
    _, _, final_chi2, _, chi2_all = linearize(x, inliers)
    mean_chi2 = final_chi2 / jnp.maximum(num_inliers.astype(jnp.float32), 1.0)
    converged = num_inliers >= config.min_num_inliers
    return GNResult(
        x=x,
        chi2=mean_chi2,
        num_inliers=num_inliers,
        num_iterations=iters,
        inlier_mask=inliers,
        converged=converged,
    )


def se3_retract(T: jnp.ndarray, dx: jnp.ndarray) -> jnp.ndarray:
    """Left-multiplicative SE(3) update with re-orthonormalization
    (reference stereouv_aligner.cpp:190-207)."""
    return lie.orthonormalize_transform(lie.exp_se3(dx) @ T)
