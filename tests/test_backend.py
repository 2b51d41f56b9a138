"""Pose-graph and Schur-BA tests on synthetic problems with known optima."""

import numpy as np
import jax.numpy as jnp

from vslam_tpu.backend import pose_graph as pg
from vslam_tpu.backend import ba as ba_mod
from vslam_tpu.ops import camera as cam_ops, lie

RNG = np.random.default_rng(11)
CAM = cam_ops.make_camera(fx=500.0, fy=500.0, cx=320.0, cy=160.0,
                          baseline_m=0.4, rows=320, cols=640)


def make_loop_trajectory(n=24, radius=10.0):
    """Ground-truth poses around a circle (closing loop)."""
    poses = []
    for k in range(n):
        ang = 2 * np.pi * k / n
        c, s = np.cos(ang), np.sin(ang)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        T[:3, 3] = [radius * s, 0.0, radius * (1 - c)]
        poses.append(T)
    return np.stack(poses)


def relative(Ta, Tb):
    return np.linalg.inv(Ta) @ Tb


def test_pose_graph_corrects_drift():
    gt = make_loop_trajectory()
    n = len(gt)
    # Build odometry chain with injected drift noise.
    noisy = [gt[0]]
    for k in range(1, n):
        T_rel = relative(gt[k - 1], gt[k])
        xi_noise = np.concatenate([RNG.normal(0, 0.03, 3), RNG.normal(0, 0.01, 3)])
        T_rel = T_rel @ np.asarray(lie.exp_se3(jnp.asarray(xi_noise.astype(np.float32))))
        noisy.append(noisy[-1] @ T_rel)
    noisy = np.stack(noisy).astype(np.float32)
    drift_before = np.linalg.norm(noisy[-1][:3, 3] - gt[-1][:3, 3])
    assert drift_before > 0.1  # noise actually drifted

    # Edges: odometry (noisy relatives as measured) + loop closure last->first
    ei, ej, eT, ew = [], [], [], []
    for k in range(1, n):
        ei.append(k - 1); ej.append(k)
        eT.append(relative(noisy[k - 1], noisy[k]))
        ew.append(1.0)
    # Ground-truth closure edge (x10 weight, reference graph_optimizer.cpp:301)
    ei.append(n - 1); ej.append(0)
    eT.append(relative(gt[n - 1], gt[0]))
    ew.append(10.0)

    graph = pg.PoseGraph(
        poses=jnp.asarray(noisy),
        edge_i=jnp.asarray(ei, jnp.int32),
        edge_j=jnp.asarray(ej, jnp.int32),
        edge_T_ij=jnp.asarray(np.stack(eT).astype(np.float32)),
        edge_weight=jnp.asarray(ew, jnp.float32),
        edge_valid=jnp.ones(len(ei), bool),
        pose_valid=jnp.ones(n, bool),
    )
    opt, chi2 = pg.optimize_pose_graph(graph, iterations=15)
    opt = np.asarray(opt)
    # End-pose now consistent with the closure.
    gap_after = np.linalg.norm(
        (np.linalg.inv(opt[-1]) @ opt[0] - relative(gt[-1], gt[0]))[:3, 3]
    )
    assert gap_after < 0.05
    # Overall trajectory moved closer to ground truth.
    err_before = np.linalg.norm(noisy[:, :3, 3] - gt[:, :3, 3], axis=1).mean()
    err_after = np.linalg.norm(opt[:, :3, 3] - gt[:, :3, 3], axis=1).mean()
    assert err_after < 0.6 * err_before


def make_ba_problem(P=6, L=128, Omax=6, pose_noise=0.05, point_noise=0.3,
                    px_noise=0.0):
    """Cameras along a line observing a point cloud; perturbed initials."""
    T_gt = []
    for k in range(P):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.3 * k, 0.0, 0.5 * k]
        T_gt.append(T)
    T_gt = np.stack(T_gt)
    xyz_gt = np.stack([
        RNG.uniform(-8, 8, L), RNG.uniform(-3, 3, L), RNG.uniform(8, 25, L)
    ], 1).astype(np.float32)

    obs_cam = np.zeros((L, Omax), np.int32)
    obs_uv4 = np.zeros((L, Omax, 4), np.float32)
    obs_mask = np.zeros((L, Omax), bool)
    for l in range(L):
        cams = RNG.choice(P, size=min(Omax, P), replace=False)
        for s, c in enumerate(cams):
            T_cw = np.linalg.inv(T_gt[c])
            p_c = T_cw[:3, :3] @ xyz_gt[l] + T_cw[:3, 3]
            if p_c[2] < 1.0:
                continue
            uv_l, uv_r, _ = cam_ops.project_stereo(CAM, jnp.asarray(p_c[None]))
            uv4 = np.concatenate([np.asarray(uv_l)[0], np.asarray(uv_r)[0]])
            uv4 += RNG.normal(0, px_noise, 4)
            obs_cam[l, s] = c
            obs_uv4[l, s] = uv4
            obs_mask[l, s] = True

    T_init = T_gt.copy()
    for k in range(1, P):  # first camera is gauge-fixed
        xi = np.concatenate([RNG.normal(0, pose_noise, 3), RNG.normal(0, pose_noise / 3, 3)])
        T_init[k] = T_gt[k] @ np.asarray(lie.exp_se3(jnp.asarray(xi.astype(np.float32))))
    xyz_init = xyz_gt + RNG.normal(0, point_noise, (L, 3)).astype(np.float32)

    prob = ba_mod.BAProblem(
        T_wc=jnp.asarray(T_init),
        xyz=jnp.asarray(xyz_init),
        obs_cam=jnp.asarray(obs_cam),
        obs_uv4=jnp.asarray(obs_uv4),
        obs_weight=jnp.ones((L, Omax), jnp.float32),
        obs_mask=jnp.asarray(obs_mask),
        lm_valid=jnp.ones(L, bool),
        cam_fixed=jnp.asarray(np.arange(P) == 0),
    )
    return prob, T_gt, xyz_gt


def test_ba_converges_to_ground_truth():
    prob, T_gt, xyz_gt = make_ba_problem()
    cfg = ba_mod.BAConfig(iterations=15, damping=1.0)
    T_out, xyz_out, chi2s = ba_mod.bundle_adjust(CAM, prob, cfg)
    T_out, xyz_out = np.asarray(T_out), np.asarray(xyz_out)
    chi2s = np.asarray(chi2s)
    assert chi2s[-1] < 1e-2 * chi2s[0]
    pose_err = np.linalg.norm(T_out[:, :3, 3] - T_gt[:, :3, 3], axis=1)
    assert pose_err.max() < 0.01
    pt_err = np.linalg.norm(xyz_out - xyz_gt, axis=1)
    assert np.median(pt_err) < 0.02


def test_ba_gauge_fixed_camera_stays():
    prob, T_gt, _ = make_ba_problem()
    T_out, _, _ = ba_mod.bundle_adjust(CAM, prob, ba_mod.BAConfig(iterations=8))
    np.testing.assert_allclose(np.asarray(T_out)[0], T_gt[0], atol=1e-4)


def test_ba_robust_to_outlier_observations():
    prob, T_gt, xyz_gt = make_ba_problem(px_noise=0.3)
    # Corrupt 10% of observations grossly.
    uv4 = np.asarray(prob.obs_uv4).copy()
    mask = np.asarray(prob.obs_mask)
    n_bad = 0
    for l in range(uv4.shape[0]):
        if RNG.random() < 0.3 and mask[l, 0]:
            uv4[l, 0] += RNG.uniform(40, 120, 4)
            n_bad += 1
    prob = prob._replace(obs_uv4=jnp.asarray(uv4))
    cfg = ba_mod.BAConfig(iterations=15, robust_chi2=25.0)
    T_out, xyz_out, _ = ba_mod.bundle_adjust(CAM, prob, cfg)
    pose_err = np.linalg.norm(np.asarray(T_out)[:, :3, 3] - T_gt[:, :3, 3], axis=1)
    assert pose_err.max() < 0.05


def _chain_graph_from(noisy, eT_odo, closure_T, n, P_pad=None, C_pad=8):
    P = P_pad or n
    poses = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    poses[:n] = noisy
    odo_T = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    odo_T[: n - 1] = np.stack(eT_odo).astype(np.float32)
    odo_w = np.zeros(P, np.float32)
    odo_w[: n - 1] = 1.0
    clo_T = np.tile(np.eye(4, dtype=np.float32), (C_pad, 1, 1))
    clo_T[0] = closure_T.astype(np.float32)
    clo_i = np.zeros(C_pad, np.int32)
    clo_j = np.zeros(C_pad, np.int32)
    clo_i[0] = n - 1
    clo_w = np.zeros(C_pad, np.float32)
    clo_w[0] = 10.0
    return pg.ChainPoseGraph(
        poses=jnp.asarray(poses),
        odo_T=jnp.asarray(odo_T),
        odo_weight=jnp.asarray(odo_w),
        odo_valid=jnp.asarray(np.arange(P) < n - 1),
        clo_i=jnp.asarray(clo_i),
        clo_j=jnp.asarray(clo_j),
        clo_T=jnp.asarray(clo_T),
        clo_weight=jnp.asarray(clo_w),
        clo_valid=jnp.asarray(np.arange(C_pad) < 1),
        pose_valid=jnp.asarray(np.arange(P) < n),
    )


def test_chain_solver_matches_dense():
    """The block-Thomas + Woodbury chain solver reaches the same optimum as
    the dense Cholesky solver on an identical chain+closure problem."""
    gt = make_loop_trajectory()
    n = len(gt)
    noisy = [gt[0]]
    rng = np.random.default_rng(7)
    eT_odo = []
    for k in range(1, n):
        T_rel = relative(gt[k - 1], gt[k])
        xi = np.concatenate([rng.normal(0, 0.03, 3), rng.normal(0, 0.01, 3)])
        T_rel = T_rel @ np.asarray(
            lie.exp_se3(jnp.asarray(xi.astype(np.float32)))
        )
        eT_odo.append(T_rel)
        noisy.append(noisy[-1] @ T_rel)
    noisy = np.stack(noisy).astype(np.float32)
    closure_T = relative(gt[n - 1], gt[0])

    ei = list(range(n - 1)) + [n - 1]
    ej = list(range(1, n)) + [0]
    eT = eT_odo + [closure_T]
    ew = [1.0] * (n - 1) + [10.0]
    dense = pg.PoseGraph(
        poses=jnp.asarray(noisy),
        edge_i=jnp.asarray(ei, jnp.int32),
        edge_j=jnp.asarray(ej, jnp.int32),
        edge_T_ij=jnp.asarray(np.stack(eT).astype(np.float32)),
        edge_weight=jnp.asarray(ew, jnp.float32),
        edge_valid=jnp.ones(len(ei), bool),
        pose_valid=jnp.ones(n, bool),
    )
    opt_d, _ = pg.optimize_pose_graph(dense, iterations=15)
    chain = _chain_graph_from(noisy, eT_odo, closure_T, n)
    opt_c, _ = pg.optimize_pose_graph_chain(chain, iterations=15)
    opt_d = np.asarray(opt_d)
    opt_c = np.asarray(opt_c)[:n]
    assert np.abs(opt_c[:, :3, 3] - opt_d[:, :3, 3]).max() < 0.02
    assert np.abs(opt_c[:, :3, :3] - opt_d[:, :3, :3]).max() < 0.01


def test_chain_solver_padded_buckets():
    """Pose/closure bucket padding (invalid rows) must not change the
    solution — the engine pads to powers of two for compile caching."""
    gt = make_loop_trajectory()
    n = len(gt)
    noisy = [gt[0]]
    rng = np.random.default_rng(3)
    eT_odo = []
    for k in range(1, n):
        T_rel = relative(gt[k - 1], gt[k])
        xi = np.concatenate([rng.normal(0, 0.02, 3), rng.normal(0, 0.008, 3)])
        T_rel = T_rel @ np.asarray(
            lie.exp_se3(jnp.asarray(xi.astype(np.float32)))
        )
        eT_odo.append(T_rel)
        noisy.append(noisy[-1] @ T_rel)
    noisy = np.stack(noisy).astype(np.float32)
    closure_T = relative(gt[n - 1], gt[0])
    tight = _chain_graph_from(noisy, eT_odo, closure_T, n)
    padded = _chain_graph_from(noisy, eT_odo, closure_T, n, P_pad=64, C_pad=16)
    opt_t, _ = pg.optimize_pose_graph_chain(tight, iterations=10)
    opt_p, _ = pg.optimize_pose_graph_chain(padded, iterations=10)
    np.testing.assert_allclose(
        np.asarray(opt_t)[:n], np.asarray(opt_p)[:n], atol=2e-3
    )


def test_chain_solver_scales_linearly():
    """VERDICT done-criterion: chain pose-graph cost grows ~linearly in P
    (the dense solver is O(P^3)).  Timing ratio P=512 vs P=128 must stay
    far below the cubic blowup (64x); allow generous slack for CPU noise."""
    import time

    def build(P, C=8, seed=0):
        rng = np.random.default_rng(seed)
        poses = [np.eye(4, dtype=np.float32)]
        odo = []
        for k in range(P - 1):
            xi = np.concatenate(
                [rng.normal(0, 0.02, 3), rng.normal(0, 0.01, 3)]
            ).astype(np.float32)
            dT = np.asarray(lie.exp_se3(jnp.asarray(xi)))
            odo.append(dT)
            poses.append(poses[-1] @ dT)
        poses = np.stack(poses).astype(np.float32)
        odo_T = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
        odo_T[: P - 1] = np.stack(odo)
        ci = rng.integers(0, P // 2, C).astype(np.int32)
        cj = (ci + P // 2).astype(np.int32)
        cT = np.stack([
            np.linalg.inv(poses[a]) @ poses[b] for a, b in zip(ci, cj)
        ]).astype(np.float32)
        return pg.ChainPoseGraph(
            poses=jnp.asarray(poses),
            odo_T=jnp.asarray(odo_T),
            odo_weight=jnp.asarray((np.arange(P) < P - 1).astype(np.float32)),
            odo_valid=jnp.asarray(np.arange(P) < P - 1),
            clo_i=jnp.asarray(ci), clo_j=jnp.asarray(cj),
            clo_T=jnp.asarray(cT),
            clo_weight=jnp.asarray(10 * np.ones(C, np.float32)),
            clo_valid=jnp.ones(C, bool),
            pose_valid=jnp.ones(P, bool),
        )

    def timed(P):
        g = build(P)
        out, _ = pg.optimize_pose_graph_chain(g, iterations=5)  # compile
        out.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(3):
            out, _ = pg.optimize_pose_graph_chain(g, iterations=5)
        out.block_until_ready()
        return (time.perf_counter() - t0) / 3

    t128 = timed(128)
    t512 = timed(512)
    # linear -> 4x; leave room for constant overheads and CPU noise, but
    # stay far below the 64x a dense-cholesky path would show.
    assert t512 < 16 * max(t128, 1e-4), (t128, t512)

    # And the P=512 solve itself stays fast in absolute terms (a CPU
    # bound with slack; the device time is the benchmark's to measure).
    assert t512 < 2.0, t512


# ---------------------------------------------------------------------------
# Hierarchical junction solver (round 4)
# ---------------------------------------------------------------------------


def test_edge_jacobian_closed_form_matches_autodiff():
    """The adjoint-based closed-form edge Jacobians equal jacfwd through
    log∘exp (VERDICT r3 #1a)."""
    poses = []
    for k in range(6):
        xi = (RNG.standard_normal(6) * np.array([5, 5, 5, 0.3, 0.3, 0.3])).astype(np.float32)
        poses.append(np.asarray(lie.exp_se3(jnp.asarray(xi))))
    poses = jnp.asarray(np.stack(poses))
    for (i, j) in [(0, 1), (2, 5), (4, 3)]:
        T_ij = lie.exp_se3(jnp.asarray((RNG.standard_normal(6) * 0.4).astype(np.float32)))
        r1, Ji1, Jj1 = pg._edge_residual_jac(poses, jnp.int32(i), jnp.int32(j), T_ij)
        r2, Ji2, Jj2 = pg._edge_residual_jac_ad(poses, jnp.int32(i), jnp.int32(j), T_ij)
        scale = max(float(jnp.abs(Jj2).max()), 1.0)
        assert float(jnp.abs(r1 - r2).max()) < 1e-5
        assert float(jnp.abs(Ji1 - Ji2).max()) / scale < 1e-4
        assert float(jnp.abs(Jj1 - Jj2).max()) / scale < 1e-4


def _drifted_multilap(P=200, laps=2.2, radius=40.0, n_clo=80, seed=5):
    """Multi-lap circle with systematic odometric drift + GT closures —
    the KITTI-00-scale regime that defeated the r3 chain solver."""
    rng = np.random.default_rng(seed)
    angles = np.linspace(0, 2 * np.pi * laps, P)
    gt = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    for k, a in enumerate(angles):
        c, s = np.cos(a), np.sin(a)
        gt[k, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        gt[k, :3, 3] = [radius * np.cos(a), 0.0, radius * np.sin(a)]
    odo = np.zeros((P - 1, 4, 4), np.float32)
    est = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    est[0] = gt[0]
    for k in range(P - 1):
        T_rel = np.linalg.inv(gt[k]) @ gt[k + 1]
        xi = np.zeros(6, np.float32)
        xi[:3] = 2e-3 * (1 + 0.1 * rng.standard_normal(3))
        xi[4] = 1e-3 * (1 + 0.1 * rng.standard_normal())
        odo[k] = T_rel @ np.asarray(lie.exp_se3(jnp.asarray(xi)))
        est[k + 1] = est[k] @ odo[k]
    per_lap = int(P / laps)
    clo = []
    if n_clo > 0:
        for j in range(per_lap + 3, P, max(1, (P - per_lap) // n_clo)):
            clo.append((j - per_lap, j, np.linalg.inv(gt[j - per_lap]) @ gt[j]))
    return gt, est, odo, clo[:n_clo]


def test_hierarchical_solver_recovers_scale_drift():
    """The production back-end path must FIX large accumulated drift —
    the r3 chain solver diverged here (14.5 m scale-run ATE, VERDICT r3
    #2); target: residual RMSE well under 10%% of the drift."""
    gt, est, odo, clo = _drifted_multilap()
    drift = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    rmse_before = np.sqrt((drift**2).mean())
    assert rmse_before > 2.0  # the problem is genuinely hard
    opt, chi2 = pg.optimize_pose_graph_hierarchical(
        est, odo, np.ones(len(est) - 1, np.float32), clo
    )
    err = np.linalg.norm(opt[:, :3, 3] - gt[:, :3, 3], axis=1)
    rmse_after = np.sqrt((err**2).mean())
    assert rmse_after < 0.1 * rmse_before
    assert rmse_after < 1.0
    assert chi2 < 1.0


def test_compact_closures():
    clo = [(0, 100, np.eye(4)), (1, 101, np.eye(4) * 2), (0, 104, np.eye(4)),
           (40, 140, np.eye(4)), (41, 141, np.eye(4))]
    cc = pg.compact_closures(clo, bucket=4)
    # (0,100),(1,101) share cell (0,25) -> newest kept; (0,104) is cell
    # (0,26); (40,140),(41,141) share cell (10,35).
    cells = {(i // 4, j // 4) for i, j, _ in cc}
    assert len(cc) == len(cells) == 3
    # newest-wins within a cell
    assert any(i == 1 and j == 101 for i, j, _ in cc)


def test_hierarchical_noop_without_closures():
    gt, est, odo, _ = _drifted_multilap(P=40, n_clo=0)
    opt, chi2 = pg.optimize_pose_graph_hierarchical(
        est, odo, np.ones(len(est) - 1, np.float32), []
    )
    np.testing.assert_allclose(opt, est)
