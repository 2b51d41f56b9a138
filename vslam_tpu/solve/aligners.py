"""Aligner instantiations of the generic GN engine.

Four solvers, all specializations of solve.gn.gauss_newton (SURVEY.md §7.1):

  stereo_uv_align   frame-to-frame 6-DoF pose from 4D [uL,vL,uR,vR]
                    reprojection residuals — reference StereoUVAligner
                    (src/aligners/stereouv_aligner.cpp:27-255)
  uvd_align         RGB-D variant, 3D [u,v,depth] residuals — reference
                    UVDAligner (src/aligners/uvd_aligner.cpp)
  icp_align         3D-3D point-to-point for loop-closure verification —
                    reference XYZAligner (src/aligners/xyz_aligner.cpp)
  update_landmarks  batched incremental 3-DoF refinement of landmark
                    positions — reference Landmark::update
                    (src/types/landmark.cpp:66-167), redesigned as an
                    information-form recursive GN vmapped over landmarks.

Jacobians come from forward-mode autodiff through the local SE(3)
parametrization (r(exp(dx) T) at dx = 0) — exact, and fused by XLA into the
same program as the residual.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from vslam_tpu.ops import camera as cam_ops
from vslam_tpu.ops import lie
from vslam_tpu.solve import gn

_ZERO6 = jnp.zeros(6, jnp.float32)


def _local_residual(r_of_T, T):
    """Evaluate residual and its Jacobian wrt the left-mult se(3) tangent."""

    def r_of_dx(dx):
        return r_of_T(lie.exp_se3(dx) @ T)

    r = r_of_dx(_ZERO6)
    J = jax.jacfwd(r_of_dx)(_ZERO6)
    return r, J


# ---------------------------------------------------------------------------
# Stereo UV aligner
# ---------------------------------------------------------------------------


class StereoUVData(NamedTuple):
    """Per-measurement data, leading dim N (fixed capacity, masked)."""

    p_prev: jnp.ndarray  # (N, 3) points in previous camera frame
    meas: jnp.ndarray  # (N, 4) measured [uL, vL, uR, vR] in current frame
    weight: jnp.ndarray  # (N,) e.g. 1 + log(n_updates) for landmarks
    # (reference stereouv_aligner.cpp:40-46)


def make_stereo_uv_residual(cam: cam_ops.CameraParams):
    def r_of_T_factory(datum):
        def r_of_T(T):
            p_cur = lie.transform_points(T, datum.p_prev)
            uv_l, uv_r, _ = cam_ops.project_stereo(cam, p_cur)
            pred = jnp.concatenate([uv_l, uv_r], axis=-1)
            return pred - datum.meas

        return r_of_T

    def residual_fn(T, datum):
        return _local_residual(r_of_T_factory(datum), T)

    def diag_fn(T, datum, r):
        # Scalar weight x inverse-depth emphasis for near points
        # (reference stereouv_aligner.cpp:57-61), as a diagonal Omega.
        z = lie.transform_points(T, datum.p_prev)[2]
        depth_w = jnp.clip(10.0 / jnp.maximum(z, 0.1), 0.2, 2.0)
        return jnp.full(4, datum.weight * depth_w, r.dtype)

    return residual_fn, diag_fn


@partial(jax.jit, static_argnames=("config",))
def stereo_uv_align(
    cam: cam_ops.CameraParams,
    data: StereoUVData,
    mask: jnp.ndarray,
    T0: jnp.ndarray,
    config: gn.GNConfig = gn.GNConfig(),
) -> gn.GNResult:
    """Estimate T_cur_prev (camera motion) from stereo reprojections."""
    residual_fn, diag_fn = make_stereo_uv_residual(cam)
    # Visibility gating: points projecting behind the camera under the
    # initial guess are excluded up front (reference skips them in
    # linearize).
    z0 = lie.transform_points(T0, data.p_prev)[:, 2]
    mask = mask & (z0 > 0.01)
    return gn.gauss_newton(
        residual_fn,
        T0,
        data,
        mask,
        config,
        retract=gn.se3_retract,
        diag_fn=diag_fn,
    )


def _stereo_r_J_analytic(cam: cam_ops.CameraParams, p: jnp.ndarray,
                         meas: jnp.ndarray):
    """Closed-form stereo reprojection residual + Jacobian wrt the
    left-multiplicative se(3) tangent [v, w] (reference analytic Jacobian,
    stereouv_aligner.cpp:142-177).

    p: (N, 3) points in the CURRENT camera frame; meas: (N, 4).
    Returns (r (N,4), J (N,4,6), z (N,)).  The autodiff path
    (_local_residual + jacfwd through exp_se3) is exact too but expands to
    ~10x the op count, so the closed form is what makes the per-frame
    solve cheap.
    """
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    zc = jnp.maximum(z, 1e-6)
    zi = 1.0 / zc
    u_l = cam.fx * x * zi + cam.cx
    v_l = cam.fy * y * zi + cam.cy
    u_r = cam.fx * (x - cam.baseline_m) * zi + cam.cx
    r = jnp.stack([u_l, v_l, u_r, v_l], axis=-1) - meas
    fxzi = cam.fx * zi
    fyzi = cam.fy * zi
    zero = jnp.zeros_like(x)
    Jp = jnp.stack([
        jnp.stack([fxzi, zero, -fxzi * x * zi], axis=-1),
        jnp.stack([zero, fyzi, -fyzi * y * zi], axis=-1),
        jnp.stack([fxzi, zero, -fxzi * (x - cam.baseline_m) * zi], axis=-1),
        jnp.stack([zero, fyzi, -fyzi * y * zi], axis=-1),
    ], axis=-2)  # (N, 4, 3)
    # d r / d w = Jp @ d(w x p)/dw = -Jp @ skew(p); row-wise a@skew(p) =
    # cross(a, p), so the rotation block is -cross(Jp_row, p).
    Jw = -jnp.cross(Jp, p[..., None, :])
    J = jnp.concatenate([Jp, Jw], axis=-1)  # (N, 4, 6)
    return r, J, z


@partial(jax.jit, static_argnames=("config",))
def stereo_uv_align_fast(
    cam: cam_ops.CameraParams,
    data: StereoUVData,
    mask: jnp.ndarray,
    T0: jnp.ndarray,
    config: gn.GNConfig = gn.GNConfig(),
) -> gn.GNResult:
    """Lean two-phase stereo pose solve with the analytic Jacobian.

    Same semantics as stereo_uv_align (robust GN to convergence, then
    inlier-only refinement with collapse rejection) but each round is a
    handful of fused vector ops instead of a vmapped-autodiff expansion.
    """
    p_prev, meas, weight = jax.lax.optimization_barrier(
        (data.p_prev, data.meas, data.weight)
    )
    kernel = jnp.float32(config.kernel_max_error)

    def linearize(T, extra_mask):
        p = lie.transform_points(T, p_prev)
        r, J, z = _stereo_r_J_analytic(cam, p, meas)
        depth_w = jnp.clip(10.0 / jnp.maximum(z, 0.1), 0.2, 2.0)
        omega = weight * depth_w  # scalar information per measurement
        vis = mask & extra_mask & (z > 0.01)
        chi2 = omega * jnp.sum(r * r, axis=-1)
        w = jnp.where(chi2 > kernel, kernel / jnp.maximum(chi2, 1e-12), 1.0)
        ow = jnp.where(vis, omega * w, 0.0)
        H = jnp.einsum("nri,n,nrj->ij", J, ow, J)
        b = jnp.einsum("nri,nr->i", J, ow[:, None] * r)
        inliers = (chi2 <= kernel) & vis
        total = jnp.sum(jnp.where(vis, chi2 * w, 0.0))
        return H, b, total, inliers

    def one_round(T, extra_mask):
        H, b, total, inliers = linearize(T, extra_mask)
        dx = gn.solve_normal_equations(
            H, b, jnp.asarray(config.damping, H.dtype)
        )
        norm = jnp.linalg.norm(dx)
        dx = dx * jnp.minimum(1.0, config.max_step_norm / jnp.maximum(norm, 1e-12))
        T_new = gn.se3_retract(T, dx)
        ok = jnp.all(jnp.isfinite(dx))
        return jnp.where(ok, T_new, T), total, inliers, jnp.where(ok, norm, 0.0)

    all_true = jnp.ones_like(mask)

    def cond1(s):
        T, prev_chi2, chi2, it, _, step = s
        rel = jnp.abs(prev_chi2 - chi2) / jnp.maximum(chi2, 1e-12)
        return (it < config.max_iterations) & (
            (it < 2) | (rel > config.tolerance) | (step > config.step_tolerance)
        )

    def body1(s):
        T, _, chi2, it, inl, _ = s
        T2, new_chi2, inliers, step = one_round(T, all_true)
        return (T2, chi2, new_chi2, it + 1, inliers, step)

    init = (T0, jnp.float32(jnp.inf), jnp.float32(1e30), jnp.int32(0), mask,
            jnp.float32(jnp.inf))
    T, _, chi2, iters, inliers, _ = jax.lax.while_loop(cond1, body1, init)

    def cond2(s):
        _, prev_chi2, chi2, it, _, step = s
        rel = jnp.abs(prev_chi2 - chi2) / jnp.maximum(chi2, 1e-12)
        return (it < config.refine_iterations) & (
            (it < 1) | (rel > config.tolerance) | (step > config.step_tolerance)
        )

    def body2(s):
        T, _, chi2, it, inl, _ = s
        T2, new_chi2, new_inl, step = one_round(T, inl)
        keep = jnp.sum(new_inl) >= config.min_num_inliers
        return (
            jnp.where(keep, T2, T), chi2,
            jnp.where(keep, new_chi2, chi2), it + 1,
            jnp.where(keep, new_inl, inl), jnp.where(keep, step, 0.0),
        )

    T, _, _, _, inliers, _ = jax.lax.while_loop(
        cond2, body2,
        (T, jnp.float32(jnp.inf), chi2, jnp.int32(0), inliers,
         jnp.float32(jnp.inf)),
    )

    _, _, final_chi2, final_inl = linearize(T, inliers)
    num_inliers = jnp.sum(final_inl).astype(jnp.int32)
    mean_chi2 = final_chi2 / jnp.maximum(num_inliers.astype(jnp.float32), 1.0)
    return gn.GNResult(
        x=T,
        chi2=mean_chi2,
        num_inliers=num_inliers,
        num_iterations=iters,
        inlier_mask=final_inl,
        converged=num_inliers >= config.min_num_inliers,
    )


# ---------------------------------------------------------------------------
# UVD aligner (RGB-D)
# ---------------------------------------------------------------------------


class UVDData(NamedTuple):
    p_prev: jnp.ndarray  # (N, 3) in previous camera frame
    meas: jnp.ndarray  # (N, 3) measured [u, v, depth_m]
    weight: jnp.ndarray  # (N,)
    depth_reliable: jnp.ndarray  # (N,) bool; unreliable -> uv-only


def make_uvd_residual(cam: cam_ops.CameraParams, depth_info_weight: float = 10.0):
    def residual_fn(T, datum):
        def r_of_T(Tx):
            p_cur = lie.transform_points(Tx, datum.p_prev)
            uv, z = cam_ops.project(cam, p_cur)
            return jnp.concatenate([uv, z[None]], axis=-1) - datum.meas

        return _local_residual(r_of_T, T)

    def diag_fn(T, datum, r):
        # Depth channel carries extra information when reliable; zero when
        # not (reference uvd_aligner.cpp:55-61 zeroes translation rows for
        # unreliable-depth points — here the depth residual is gated).
        dw = jnp.where(datum.depth_reliable, depth_info_weight, 0.0)
        return jnp.stack(
            [datum.weight, datum.weight, datum.weight * dw]
        ).astype(r.dtype)

    return residual_fn, diag_fn


@partial(jax.jit, static_argnames=("config",))
def uvd_align(
    cam: cam_ops.CameraParams,
    data: UVDData,
    mask: jnp.ndarray,
    T0: jnp.ndarray,
    config: gn.GNConfig = gn.GNConfig(),
) -> gn.GNResult:
    residual_fn, diag_fn = make_uvd_residual(cam)
    z0 = lie.transform_points(T0, data.p_prev)[:, 2]
    mask = mask & (z0 > 0.01)
    return gn.gauss_newton(
        residual_fn, T0, data, mask, config, retract=gn.se3_retract,
        diag_fn=diag_fn,
    )


# ---------------------------------------------------------------------------
# Point-to-point ICP (loop-closure geometric verification)
# ---------------------------------------------------------------------------


class ICPData(NamedTuple):
    p_moving: jnp.ndarray  # (N, 3) points in query frame
    p_fixed: jnp.ndarray  # (N, 3) corresponding points in reference frame
    weight: jnp.ndarray  # (N,) e.g. correspondence matching ratio
    # (reference xyz_aligner.cpp:13-40)


def make_icp_residual():
    def residual_fn(T, datum):
        def r_of_T(Tx):
            return lie.transform_points(Tx, datum.p_moving) - datum.p_fixed

        return _local_residual(r_of_T, T)

    def diag_fn(T, datum, r):
        return jnp.full(3, datum.weight, r.dtype)

    return residual_fn, diag_fn


@partial(jax.jit, static_argnames=("config",))
def icp_align(
    data: ICPData,
    mask: jnp.ndarray,
    T0: jnp.ndarray,
    config: gn.GNConfig = gn.GNConfig(),
) -> gn.GNResult:
    """Estimate T_ref_query aligning moving onto fixed points."""
    residual_fn, diag_fn = make_icp_residual()
    return gn.gauss_newton(
        residual_fn, T0, data, mask, config, retract=gn.se3_retract,
        diag_fn=diag_fn,
    )


# ---------------------------------------------------------------------------
# Batched landmark refinement
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("min_forced_updates", "min_meas_for_opt",
                                   "max_t_err_depth_ratio"))
def update_landmarks(
    cam: cam_ops.CameraParams,
    xyz_world: jnp.ndarray,  # (M, 3) current landmark estimates
    H_acc: jnp.ndarray,  # (M, 3, 3) accumulated information
    T_world_cam: jnp.ndarray,  # (4, 4) current camera pose
    meas_uv4: jnp.ndarray,  # (M, 4) measured [uL, vL, uR, vR]
    obs_mask: jnp.ndarray,  # (M,) landmarks observed this frame
    kernel_max_error_px2: float = 9.0 * 4,
    prior_damping: float = 1.0,
    n_updates: jnp.ndarray | None = None,  # (M,) prior update counts
    min_forced_updates: int = 0,
    min_meas_for_opt: int = 0,
    max_t_err_depth_ratio: float = 0.0,
):
    """One information-form GN step per observed landmark, batched over M.

    Redesign of Landmark::update (src/types/landmark.cpp:66-167): instead of
    re-iterating over a stored measurement vector per landmark (pointer
    chasing), each landmark carries a 3x3 information matrix accumulated
    over its track; a new stereo observation contributes J^T.Omega.J and the
    position takes a damped step.  Robust gate: observations whose
    reprojection chi2 exceeds the kernel are downweighted, and steps for
    unobserved landmarks are zero.

    LandmarkParameters wiring (reference parameters.h:97-126):
      min_forced_updates — the first N observations are treated as inliers
        at full weight (reference forced-update phase, landmark.cpp:75-84);
      min_meas_for_opt — the position step is withheld (information still
        accumulates) until the landmark has this many measurements
        (landmark.cpp:86-90);
      max_t_err_depth_ratio — a solved step larger than ratio*depth is an
        outlier measurement and is rejected (landmark.cpp:120-133).

    Returns (xyz_new (M,3), H_new (M,3,3), chi2 (M,), inlier (M,)).
    """
    T_cam_world = lie.inverse(T_world_cam)
    if n_updates is None:
        n_updates = jnp.full(xyz_world.shape[0], 1 << 20, jnp.int32)

    def per_landmark(xyz, H, meas, n_up):
        def r_of_x(x):
            p_cam = lie.transform_points(T_cam_world, x)
            uv_l, uv_r, _ = cam_ops.project_stereo(cam, p_cam)
            return jnp.concatenate([uv_l, uv_r]) - meas

        r = r_of_x(xyz)
        J = jax.jacfwd(r_of_x)(xyz)  # (4, 3)
        chi2 = jnp.sum(r * r)
        w = jnp.where(chi2 > kernel_max_error_px2, kernel_max_error_px2 / jnp.maximum(chi2, 1e-9), 1.0)
        w = jnp.where(n_up < min_forced_updates, 1.0, w)
        Hm = w * (J.T @ J)
        bm = w * (J.T @ r)
        H_new = H + Hm
        dx = gn.solve_normal_equations(H_new, bm, prior_damping)
        depth = lie.transform_points(T_cam_world, xyz)[2]
        step_ok = jnp.asarray(True)
        if max_t_err_depth_ratio > 0.0:
            step_ok = step_ok & (
                jnp.linalg.norm(dx)
                <= max_t_err_depth_ratio * jnp.maximum(depth, 0.1)
            )
        if min_meas_for_opt > 0:
            step_ok = step_ok & (n_up + 1 >= min_meas_for_opt)
        xyz_new = jnp.where(step_ok, xyz + dx, xyz)
        return xyz_new, H_new, chi2, chi2 <= kernel_max_error_px2

    xyz_n, H_n, chi2, inl = jax.vmap(per_landmark)(
        xyz_world, H_acc, meas_uv4, n_updates
    )
    m3 = obs_mask[:, None]
    xyz_out = jnp.where(m3, xyz_n, xyz_world)
    H_out = jnp.where(obs_mask[:, None, None], H_n, H_acc)
    return xyz_out, H_out, chi2, inl & obs_mask


@jax.jit
def update_landmarks_uvd(
    cam: cam_ops.CameraParams,
    xyz_world: jnp.ndarray,
    H_acc: jnp.ndarray,
    T_world_cam: jnp.ndarray,
    meas_uvd: jnp.ndarray,  # (M, 3) measured [u, v, depth_m]
    obs_mask: jnp.ndarray,
    kernel_max_error: float = 9.0 * 3,
    prior_damping: float = 1.0,
    depth_weight: float = 100.0,
):
    """RGB-D variant of update_landmarks: [u, v, depth] residual with the
    depth channel weighted in (pixel^2-comparable) units."""
    T_cam_world = lie.inverse(T_world_cam)
    sqrt_dw = jnp.sqrt(depth_weight)

    def per_landmark(xyz, H, meas):
        def r_of_x(x):
            p_cam = lie.transform_points(T_cam_world, x)
            uv, z = cam_ops.project(cam, p_cam)
            return jnp.concatenate([uv - meas[:2], (z - meas[2])[None] * sqrt_dw])

        r = r_of_x(xyz)
        J = jax.jacfwd(r_of_x)(xyz)  # (3, 3)
        chi2 = jnp.sum(r * r)
        w = jnp.where(chi2 > kernel_max_error, kernel_max_error / jnp.maximum(chi2, 1e-9), 1.0)
        H_new = H + w * (J.T @ J)
        dx = gn.solve_normal_equations(H_new, w * (J.T @ r), prior_damping)
        return xyz + dx, H_new, chi2, chi2 <= kernel_max_error

    xyz_n, H_n, chi2, inl = jax.vmap(per_landmark)(xyz_world, H_acc, meas_uvd)
    xyz_out = jnp.where(obs_mask[:, None], xyz_n, xyz_world)
    H_out = jnp.where(obs_mask[:, None, None], H_n, H_acc)
    return xyz_out, H_out, chi2, inl & obs_mask
