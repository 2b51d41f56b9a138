"""Schur-complement bundle adjustment, built landmark-parallel from the start.

Replaces the reference's g2o full-BA mode (GraphOptimizer::addPoseWithFactors
+ optimizeFactorGraph, src/map_optimization/graph_optimizer.cpp:319-409,
459-488, single-threaded sparse CHOLMOD) with the accelerator design from
SURVEY.md §7.1: the landmark block of the Hessian is 3x3 block-diagonal, so
landmark elimination is a vmapped batch of 3x3 inversions — embarrassingly
parallel over landmarks, which is exactly the axis parallel/sharded_ba.py
shards across devices.  The reduced camera system (6P x 6P, P = keyframes,
small for an accelerator) is assembled by scatter-add and solved densely.

Observation layout is grouped-by-landmark with a fixed max-observations pad
(L, Omax): every per-landmark quantity is a clean vmap, and the cross-camera
Schur blocks -Y_a W^-1 Y_b^T enumerate slot pairs (a, b) within a landmark.

Robust kernel: reference-style chi2 clamping as IRLS weights.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from vslam_tpu.ops import camera as cam_ops
from vslam_tpu.ops import lie


class BAProblem(NamedTuple):
    """Bundle-adjustment problem with landmark-grouped observations.

    The optional odometry rows add the reference's pose-pose factors
    (GraphOptimizer::_setPoseEdge, graph_optimizer.cpp:490-526): without
    them a windowed BA is anchored only by its gauge camera and the free
    boundary wanders against the tracker trajectory (r4 ablation: pose
    write-back doubled open-loop ATE until these priors were added).
    """

    T_wc: jnp.ndarray  # (P, 4, 4) camera poses (world <- cam)
    xyz: jnp.ndarray  # (L, 3) landmark world positions
    obs_cam: jnp.ndarray  # (L, Omax) int32 camera index per observation
    obs_uv4: jnp.ndarray  # (L, Omax, 4) stereo measurements [uL,vL,uR,vR]
    obs_weight: jnp.ndarray  # (L, Omax) f32
    obs_mask: jnp.ndarray  # (L, Omax) bool
    lm_valid: jnp.ndarray  # (L,) bool
    cam_fixed: jnp.ndarray  # (P,) bool — gauge-fixed cameras
    # Odometry pose-pose factors between consecutive cameras: row k is the
    # measured T_{k,k+1}; odo_weight scales the shared information diag
    # (0 disables the edge; None disables the factor family entirely).
    odo_T: jnp.ndarray | None = None  # (P, 4, 4); row P-1 is padding
    odo_weight: jnp.ndarray | None = None  # (P,) f32
    odo_info: jnp.ndarray | None = None  # (6,) per-dim information diag


class BAConfig(NamedTuple):
    iterations: int = 10
    damping: float = 1.0
    robust_chi2: float = 25.0
    max_pose_step: float = 1.0
    max_point_step: float = 5.0
    fixed_weight: float = 1e8


def _linearize_landmark(cam: cam_ops.CameraParams, T_wc, xyz_l, obs_cam_l,
                        obs_uv4_l, obs_w_l, obs_mask_l, robust_chi2):
    """Per-landmark linearization over its Omax observation slots.

    Returns (W (3,3), b_l (3,), U_blocks (O,6,6), Y (O,6,3), b_c (O,6),
    chi2_sum) where U/Y/b_c are per-slot contributions to the camera system.
    """

    def per_obs(c_idx, uv4, w, m):
        T = T_wc[c_idx]

        def r_of(dx_cam, x):
            Twc = lie.exp_se3(dx_cam) @ T
            p_c = lie.transform_points(lie.inverse(Twc), x)
            uv_l, uv_r, _ = cam_ops.project_stereo(cam, p_c)
            return jnp.concatenate([uv_l, uv_r]) - uv4

        z6 = jnp.zeros(6, xyz_l.dtype)
        r = r_of(z6, xyz_l)
        Jc = jax.jacfwd(r_of, argnums=0)(z6, xyz_l)  # (4, 6)
        Jl = jax.jacfwd(r_of, argnums=1)(z6, xyz_l)  # (4, 3)
        chi2 = jnp.sum(r * r)
        rw = jnp.where(chi2 > robust_chi2, robust_chi2 / jnp.maximum(chi2, 1e-12), 1.0)
        ww = w * rw * m
        return r, Jc, Jl, ww, chi2 * ww

    r, Jc, Jl, ww, chi2 = jax.vmap(per_obs)(
        obs_cam_l, obs_uv4_l, obs_w_l, obs_mask_l
    )
    W = jnp.einsum("ori,o,orj->ij", Jl, ww, Jl)  # (3, 3)
    b_l = jnp.einsum("ori,o,or->i", Jl, ww, r)  # (3,)
    U = jnp.einsum("ori,o,orj->oij", Jc, ww, Jc)  # (O, 6, 6)
    Y = jnp.einsum("ori,o,orj->oij", Jc, ww, Jl)  # (O, 6, 3)
    b_c = jnp.einsum("ori,o,or->oi", Jc, ww, r)  # (O, 6)
    return W, b_l, U, Y, b_c, jnp.sum(chi2)


def build_reduced_system(cam, T_wc, prob: BAProblem, config: BAConfig):
    """Assemble the Schur-reduced camera system from this (shard of the)
    landmark set.  Pure function of arrays — reused verbatim inside
    shard_map in parallel/sharded_ba.py, where the outputs are psum-reduced.

    Returns (S (P,6,P,6), b_S (P,6), Winv (L,3,3), b_l (L,3), Y (L,O,6,3),
    chi2).
    """
    P = T_wc.shape[0]
    W, b_l, U, Y, b_c, chi2 = jax.vmap(
        lambda x, oc, ouv, ow, om: _linearize_landmark(
            cam, T_wc, x, oc, ouv, ow, om, config.robust_chi2
        )
    )(prob.xyz, prob.obs_cam, prob.obs_uv4, prob.obs_weight, prob.obs_mask)

    lm_w = prob.lm_valid.astype(T_wc.dtype)
    W = W * lm_w[:, None, None]
    b_l = b_l * lm_w[:, None]
    U = U * lm_w[:, None, None, None]
    Y = Y * lm_w[:, None, None, None]
    b_c = b_c * lm_w[:, None, None]
    chi2 = jnp.sum(chi2 * lm_w)

    eye3 = jnp.eye(3, dtype=T_wc.dtype)
    Winv = jnp.linalg.inv(W + config.damping * eye3)  # (L, 3, 3)

    # Camera block-diagonal and gradient.
    S = jnp.zeros((P, 6, P, 6), T_wc.dtype)
    cams_flat = prob.obs_cam.reshape(-1)
    S = S.at[cams_flat, :, cams_flat, :].add(U.reshape(-1, 6, 6))
    b_S = jnp.zeros((P, 6), T_wc.dtype).at[cams_flat].add(b_c.reshape(-1, 6))

    # Schur cross terms: for each landmark, all slot pairs (a, b).
    YW = jnp.einsum("loij,ljk->loik", Y, Winv)  # (L, O, 6, 3)
    cross = jnp.einsum("laik,lbjk->labij", YW, Y)  # (L, O, O, 6, 6)
    L_, O_ = prob.obs_cam.shape
    ca = jnp.broadcast_to(prob.obs_cam[:, :, None], (L_, O_, O_)).reshape(-1)
    cb = jnp.broadcast_to(prob.obs_cam[:, None, :], (L_, O_, O_)).reshape(-1)
    S = S.at[ca, :, cb, :].add(-cross.reshape(-1, 6, 6))
    # b_S = b_c - Y W^-1 b_l, scattered per observation's camera.
    b_S = b_S - jnp.zeros((P, 6), T_wc.dtype).at[cams_flat].add(
        jnp.einsum("loik,lk->loi", YW, b_l).reshape(-1, 6)
    )
    return S, b_S, Winv, b_l, Y, chi2


def solve_reduced_and_backsub(T_wc, prob, S, b_S, Winv, b_l, Y, config: BAConfig):
    """Solve the reduced camera system and back-substitute landmark steps.

    The landmark back-substitution is local to each landmark (shard-local
    in the distributed case): dx_l = -Winv (b_l + sum_a Y_a^T dx_{c_a}).
    """
    P = T_wc.shape[0]
    eye6 = jnp.eye(6, dtype=T_wc.dtype)
    diag = config.damping + jnp.where(prob.cam_fixed, config.fixed_weight, 0.0)
    pr = jnp.arange(P)
    S = S.at[pr, :, pr, :].add(diag[:, None, None] * eye6)

    # Odometry pose-pose factors (reference _setPoseEdge,
    # graph_optimizer.cpp:490-526) — added HERE, after the landmark shards
    # were (psum-)combined, so the sharded path counts them exactly once.
    if prob.odo_T is not None:
        from vslam_tpu.backend import pose_graph as pg

        ks = jnp.arange(P)
        r_o, Ji, Jj = jax.vmap(
            lambda i, j, T: pg._edge_residual_jac(T_wc, i, j, T)
        )(ks, jnp.minimum(ks + 1, P - 1), prob.odo_T)
        w = prob.odo_weight * (ks < P - 1)
        om = prob.odo_info  # (6,) information diag
        Hii = jnp.einsum("eri,e,r,erj->eij", Ji, w, om, Ji)
        Hjj = jnp.einsum("eri,e,r,erj->eij", Jj, w, om, Jj)
        Hij = jnp.einsum("eri,e,r,erj->eij", Ji, w, om, Jj)
        bi = jnp.einsum("eri,e,r,er->ei", Ji, w, om, r_o)
        bj = jnp.einsum("eri,e,r,er->ei", Jj, w, om, r_o)
        jj = jnp.minimum(ks + 1, P - 1)
        S = S.at[ks, :, ks, :].add(Hii)
        S = S.at[jj, :, jj, :].add(Hjj)
        S = S.at[ks, :, jj, :].add(Hij)
        S = S.at[jj, :, ks, :].add(jnp.swapaxes(Hij, -1, -2))
        b_S = b_S.at[ks].add(bi).at[jj].add(bj)

    Sd = S.reshape(P * 6, P * 6)
    bd = b_S.reshape(P * 6)
    Lc = jax.scipy.linalg.cho_factor(Sd, lower=True)
    dx_c = -jax.scipy.linalg.cho_solve(Lc, bd).reshape(P, 6)
    n = jnp.linalg.norm(dx_c, axis=1, keepdims=True)
    dx_c = dx_c * jnp.minimum(1.0, config.max_pose_step / jnp.maximum(n, 1e-12))
    dx_c = jnp.where(jnp.isfinite(dx_c), dx_c, 0.0)

    # Landmark back-substitution.
    dx_cam_per_obs = dx_c[prob.obs_cam]  # (L, O, 6)
    corr = jnp.einsum("loik,loi->lk", Y, dx_cam_per_obs)  # (L, 3)
    dx_l = -jnp.einsum("lij,lj->li", Winv, b_l + corr)
    nl = jnp.linalg.norm(dx_l, axis=1, keepdims=True)
    dx_l = dx_l * jnp.minimum(1.0, config.max_point_step / jnp.maximum(nl, 1e-12))
    dx_l = jnp.where(jnp.isfinite(dx_l), dx_l, 0.0)
    dx_l = dx_l * prob.lm_valid[:, None]

    T_new = jax.vmap(lambda T, d: lie.orthonormalize_transform(lie.exp_se3(d) @ T))(
        T_wc, dx_c
    )
    xyz_new = prob.xyz + dx_l
    return T_new, xyz_new


@partial(jax.jit, static_argnames=("config",))
def bundle_adjust(
    cam: cam_ops.CameraParams, prob: BAProblem, config: BAConfig = BAConfig()
):
    """Full single-device Schur BA: iterate linearize/solve/backsub.

    Returns (T_wc (P,4,4), xyz (L,3), chi2_history (iters,)).
    """

    def one_iter(carry, _):
        T_wc, xyz = carry
        p = prob._replace(xyz=xyz)
        S, b_S, Winv, b_l, Y, chi2 = build_reduced_system(cam, T_wc, p, config)
        T_new, xyz_new = solve_reduced_and_backsub(T_wc, p, S, b_S, Winv, b_l, Y, config)
        return (T_new, xyz_new), chi2

    (T_out, xyz_out), chi2s = jax.lax.scan(
        one_iter, (prob.T_wc, prob.xyz), None, length=config.iterations
    )
    return T_out, xyz_out, chi2s
