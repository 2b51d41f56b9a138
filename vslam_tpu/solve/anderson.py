"""FAST-ICP: Anderson-accelerated point-to-point ICP on SE(3).

Array-program redesign of the fork's signature closure aligner
(src/aligners/fast_aligner.cpp:105-315 + AndersonAcceleration.h): the
fixed-point iteration is one IRLS-weighted Procrustes solve per round
(reference point_to_point, fast_aligner.cpp:282-315), and type-II Anderson
mixing runs in se(3) log coordinates (the reference takes matrix logs via
RealSchur, fast_aligner.cpp:232-280; here lie.log_se3's closed form).  The
whole solver is one lax.scan program — history matrices are fixed-size
(6, m) and the mixing weights come from a tiny least-squares solve, so
acceleration adds no host round-trips.

Safeguard: a round whose accelerated iterate raises the robust energy falls
back to the plain Procrustes iterate and restarts the history (the
reference's energy check, fast_aligner.cpp:150-176).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from vslam_tpu.ops import lie
from vslam_tpu.solve import gn
from vslam_tpu.solve.aligners import ICPData


def _weighted_procrustes(p_mov, p_fix, w):
    """Closed-form weighted point-to-point alignment (Kabsch/Umeyama)."""
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    mu_m = jnp.einsum("n,ni->i", w, p_mov) / wsum
    mu_f = jnp.einsum("n,ni->i", w, p_fix) / wsum
    S = jnp.einsum("n,ni,nj->ij", w, p_fix - mu_f, p_mov - mu_m)
    U, _, Vt = jnp.linalg.svd(S)
    d = jnp.sign(jnp.linalg.det(U @ Vt))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0]) .at[2].set(d))
    R = U @ D @ Vt
    t = mu_f - R @ mu_m
    return lie.make_transform(R, t)


def _robust_weights(data: ICPData, mask, T, kernel):
    p = lie.transform_point_cloud(T, data.p_moving)
    chi2 = jnp.sum((p - data.p_fixed) ** 2, axis=1)
    w = jnp.where(chi2 > kernel, kernel / jnp.maximum(chi2, 1e-12), 1.0)
    w = w * data.weight * mask
    energy = jnp.sum(jnp.minimum(chi2, kernel) * data.weight * mask)
    inliers = (chi2 <= kernel) & (mask > 0)
    return w, energy, inliers, chi2


@partial(jax.jit, static_argnames=("config", "window", "max_rounds"))
def fast_icp_align(
    data: ICPData,
    mask: jnp.ndarray,
    T0: jnp.ndarray,
    config: gn.GNConfig = gn.GNConfig(),
    window: int = 5,
    max_rounds: int = 30,
) -> gn.GNResult:
    """Anderson-accelerated ICP; same result contract as aligners.icp_align."""
    m = window
    mask_f = mask.astype(jnp.float32)

    def G(T):
        """One IRLS + Procrustes fixed-point step."""
        w, _, _, _ = _robust_weights(data, mask_f, T, config.kernel_max_error)
        return _weighted_procrustes(data.p_moving, data.p_fixed, w)

    def energy_of(T):
        _, e, _, _ = _robust_weights(data, mask_f, T, config.kernel_max_error)
        return e

    def round_fn(carry, _):
        u, Fh, Gh, k, e_prev = carry
        # u: current iterate in se(3) log coords; Fh/Gh: residual/value
        # history columns (6, m); k: valid history length.
        T = lie.exp_se3(u)
        g = lie.log_se3(G(T))
        f = g - u

        # Shift histories and insert the newest column at slot 0.
        Fh = jnp.concatenate([f[:, None], Fh[:, : m - 1]], axis=1)
        Gh = jnp.concatenate([g[:, None], Gh[:, : m - 1]], axis=1)
        k = jnp.minimum(k + 1, m)

        # Type-II mixing: minimize ||F gamma|| with sum(gamma) = 1 over the
        # valid history, via differences against the newest column
        # (AndersonAcceleration.h:60-115's normal equations).
        valid = (jnp.arange(m) < k).astype(f.dtype)
        dF = (Fh - f[:, None]) * valid  # column 0 becomes zero
        A = dF.T @ dF + 1e-10 * jnp.eye(m, dtype=f.dtype)
        b = dF.T @ f
        theta = jnp.linalg.solve(A, b)
        u_acc = g - (Gh - g[:, None]) @ (theta * valid)

        # Safeguard: accept acceleration only if it lowers the energy.
        e_plain = energy_of(lie.exp_se3(g))
        e_acc = energy_of(lie.exp_se3(u_acc))
        ok_acc = jnp.isfinite(e_acc) & (e_acc <= e_plain)
        u_next = jnp.where(ok_acc, u_acc, g)
        # On rejection restart the history (reference resets its buffers).
        k = jnp.where(ok_acc, k, 1)
        e_next = jnp.where(ok_acc, e_acc, e_plain)
        return (u_next, Fh, Gh, k, e_next), e_next

    u0 = lie.log_se3(T0)
    init = (
        u0,
        jnp.zeros((6, m), u0.dtype),
        jnp.zeros((6, m), u0.dtype),
        jnp.int32(0),
        energy_of(T0),
    )
    (u, _, _, _, _), energies = jax.lax.scan(round_fn, init, None, length=max_rounds)
    T = lie.orthonormalize_transform(lie.exp_se3(u))

    _, e_fin, inliers, chi2 = _robust_weights(
        data, mask_f, T, config.kernel_max_error
    )
    num_inliers = jnp.sum(inliers).astype(jnp.int32)
    mean_chi2 = jnp.sum(jnp.where(inliers, chi2, 0.0)) / jnp.maximum(
        num_inliers.astype(jnp.float32), 1.0
    )
    return gn.GNResult(
        x=T,
        chi2=mean_chi2,
        num_inliers=num_inliers,
        num_iterations=jnp.int32(max_rounds),
        inlier_mask=inliers,
        converged=num_inliers >= config.min_num_inliers,
    )
