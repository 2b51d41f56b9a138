#!/usr/bin/env python3
"""On-GPU smoke check of the SLAM main path, in one process on one card.

    python chip_smoke.py               # one GPU: phases 1-4
    python chip_smoke.py --four-cards  # four GPUs: the sharded paths only

Phases (one card):
  1. kernel parity at 376x1241 against the plain references, computed on
     the host CPU in the same process with full-f32 matmuls: BRIEF planes
     (plain, rotated banks 0 and 5, and the Pallas-Triton planes kernel
     the card runs) against the numpy oracle, FAST-9/12
     NMS score maps and keypoints, stereo matches, int8-matmul Hamming
     against popcount, the stereo pose solve and the hierarchical pose
     graph at 341 keyframes;
  2. the 128-frame, 82 m closed loop through SlamEngine.process() at
     KITTI width (BA off): closures fire, 0 tracking breaks, ATE <= 0.10 m;
  3. the CLI (`run` then `eval`) on configurations/configuration_kitti.yaml
     over a 64-frame synthetic KITTI directory written as PNG files;
  4. the phase-2 frames with windowed full BA on.

With --four-cards: sharded BA and sharded descriptor search on a 4-card
mesh against one card, and the phase-2 closed loop sharded across the
cards against the same frames unsharded.

It refuses to run without a GPU (exit 2).  Every phase runs; a failed
check or an exception in any phase makes the exit code 1.  The last line
of standard output is one JSON object, printed only when every phase
passed.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import os
import struct
import sys
import tempfile
import time
import traceback
import zlib

import numpy as np

# The plain references run on the host CPU in this same process: keep the
# CPU platform next to the GPU when JAX_PLATFORMS names platforms.
_platforms = os.environ.get("JAX_PLATFORMS")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
KITTI_CONFIG = os.path.join(ROOT, "configurations", "configuration_kitti.yaml")
ATE_LIMIT_M = 0.10


class Checks:
    """Collects named checks; a phase fails if any of its checks fails."""

    def __init__(self):
        self.failed: list[str] = []

    def check(self, name: str, ok: bool, detail: str = "") -> None:
        print(f"  [{'PASS' if ok else 'FAIL'}] {name}" + (f": {detail}" if detail else ""),
              flush=True)
        if not ok:
            self.failed.append(name)

    def phase(self, name: str, fn, *args, **kwargs):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            out = fn(self, *args, **kwargs)
        except Exception:  # report every phase; the exit code carries it
            traceback.print_exc()
            self.failed.append(f"{name} (exception)")
            out = None
        print(f"   {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out


def run_on(device, fn, *arrays):
    """fn(*arrays) with the arrays committed to `device`; host result."""
    with jax.default_device(device):
        args = [jax.device_put(a, device) for a in arrays]
        return jax.device_get(fn(*args))


def kitti_camera(rows=376, cols=1241):
    from vslam_tpu.ops import camera as cam_ops

    return cam_ops.make_camera(fx=718.856, fy=718.856, cx=607.19, cy=185.22,
                               baseline_m=0.5372, rows=rows, cols=cols)


def differing_bits(a: np.ndarray, b: np.ndarray) -> int:
    x = np.bitwise_xor(np.asarray(a, np.uint32), np.asarray(b, np.uint32))
    return int(np.unpackbits(x.view(np.uint8)).sum())


# ---------------------------------------------------------------------------
# Phase 1: kernel parity
# ---------------------------------------------------------------------------


def phase_kernels(c: Checks, dev, ref, rows=376, cols=1241, n_db=45056,
                  n_query=1024, n_keyframes=341):
    from vslam_tpu.frontend import brief, brief_gpu, detect, matching
    from vslam_tpu.frontend.orb import box_sum
    from vslam_tpu.io import synthetic
    from vslam_tpu.ops import hamming, lie
    from vslam_tpu.solve import aligners

    cam = kitti_camera(rows, cols)
    poses = synthetic.circle_trajectory(8, radius=13.0)
    world = synthetic.make_world(cam, n_points=7000, seed=0, poses=poses)
    img_l, img_r, _ = synthetic.render_frame(world, 3)

    # BRIEF planes: the device planes of one smoothed image against the
    # numpy oracle on the same smoothed values.
    smooth = np.asarray(run_on(dev, jax.jit(lambda x: box_sum(x, 2)), img_l))
    for name, pat in (("plain", brief._PAT), ("bank 0", brief._ROT_PATS[0]),
                      ("bank 5", brief._ROT_PATS[5])):
        t0 = time.perf_counter()
        got = run_on(dev, jax.jit(lambda s, p=pat: brief.planes_from_pattern(s, p)),
                     smooth)
        dt = time.perf_counter() - t0
        nbits = differing_bits(got, brief.planes_numpy(smooth, pat))
        c.check(f"BRIEF planes {name} vs numpy oracle", nbits == 0,
                f"{nbits} differing bits (first call incl. compile {dt:.2f} s)")
    # The Pallas-Triton planes kernel the card runs, on the same values.
    t0 = time.perf_counter()
    got = run_on(dev, lambda x: brief_gpu.planes_from_pattern_gpu(x[None], brief._PAT)[0],
                 smooth)
    dt = time.perf_counter() - t0
    nbits = differing_bits(got, brief.planes_numpy(smooth, brief._PAT))
    c.check("BRIEF planes Triton kernel vs numpy oracle", nbits == 0,
            f"{nbits} differing bits (first call incl. compile {dt:.2f} s)")
    # End to end (box sum + planes) on the card against the CPU, single
    # and batched (the split front-end vmaps it).
    nbits = differing_bits(run_on(dev, brief.dense_bit_planes, img_l),
                           run_on(ref, brief.dense_bit_planes, img_l))
    c.check("dense_bit_planes card vs CPU", nbits == 0, f"{nbits} differing bits")
    pair = np.stack([img_l, img_r])
    vplanes = jax.jit(jax.vmap(brief.dense_bit_planes))
    nbits = differing_bits(run_on(dev, vplanes, pair), run_on(ref, vplanes, pair))
    c.check("vmapped dense_bit_planes card vs CPU", nbits == 0, f"{nbits} differing bits")

    thr = np.float32(20.0)
    for arc, det in ((9, "FAST"), (12, "FAST12")):
        score = jax.jit(lambda x, t, a=arc: detect.nms3(detect.fast_score_map(x, t, arc_len=a)))
        d = np.abs(run_on(dev, score, img_l, thr) - run_on(ref, score, img_l, thr))
        c.check(f"FAST-{arc} NMS score map", float(d.max()) <= 1e-3,
                f"max |diff| {float(d.max()):.3g}")
        kp = jax.jit(lambda x, t, dd=det: detect.detect_keypoints(x, t, 16, 1024, 20, dd))
        kd, kc = run_on(dev, kp, img_l, thr), run_on(ref, kp, img_l, thr)
        sd = {tuple(p) for p in np.asarray(kd.uv)[np.asarray(kd.valid)].tolist()}
        sc = {tuple(p) for p in np.asarray(kc.uv)[np.asarray(kc.valid)].tolist()}
        c.check(f"FAST-{arc} keypoint set", sd == sc, f"{len(sd)} vs {len(sc)} keypoints")

    # Stereo matching on identical CPU-made keypoints and descriptors.
    def describe(a, b, t):
        kl = detect.detect_keypoints(a, t, 16, 1024, 20, "FAST")
        kr = detect.detect_keypoints(b, t, 16, 1024, 20, "FAST")
        planes = brief.dense_planes_pair(a, b)
        return (kl.uv, brief.gather_descriptors(planes[0], a.shape, kl.uv), kl.valid,
                kr.uv, brief.gather_descriptors(planes[1], b.shape, kr.uv), kr.valid)

    feats = run_on(ref, jax.jit(describe), img_l, img_r, thr)
    gates = (np.int32(60), np.float32(1.5), np.float32(0.0), np.float32(200.0))
    md = run_on(dev, matching.match_stereo, *feats, *gates)
    mc = run_on(ref, matching.match_stereo, *feats, *gates)
    same = np.array_equal(md.valid, mc.valid) and np.array_equal(
        np.where(mc.valid, md.right_idx, -1), np.where(mc.valid, mc.right_idx, -1))
    c.check("stereo matches", bool(same), f"{int(np.sum(mc.valid))} matches")

    # Hamming: int8 matmul on the card against popcount on the CPU.
    rng = np.random.default_rng(1)
    db = rng.integers(0, 2**32, size=(n_db, 8), dtype=np.uint32)
    q = db[rng.choice(n_db, n_query, replace=False)].copy()
    q[: n_query // 2, 0] ^= np.uint32(0b1011)
    hd = run_on(dev, jax.jit(hamming.hamming_matrix_mxu), q, db)
    hc = run_on(ref, jax.jit(hamming.hamming_matrix), q, db)
    c.check(f"Hamming {n_query} x {n_db}: int8 matmul vs popcount",
            np.array_equal(hd, hc), f"{int(np.sum(hd != hc))} differing entries")

    # Stereo pose solve on noisy synthetic correspondences.
    n = 256
    z = rng.uniform(4.0, 40.0, n)
    u = rng.uniform(100, cols - 100, n)
    v = rng.uniform(40, rows - 40, n)
    p_prev = np.stack([(u - float(cam.cx)) / float(cam.fx) * z,
                       (v - float(cam.cy)) / float(cam.fy) * z, z], 1).astype(np.float32)
    xi = (rng.standard_normal(6) * np.array([0.3, 0.1, 0.5, 0.02, 0.04, 0.01])).astype(np.float32)
    T_true = np.asarray(lie.exp_se3(jnp.asarray(xi)))
    p_cur = p_prev @ T_true[:3, :3].T + T_true[:3, 3]
    uv_l = np.stack([float(cam.fx) * p_cur[:, 0] / p_cur[:, 2] + float(cam.cx),
                     float(cam.fy) * p_cur[:, 1] / p_cur[:, 2] + float(cam.cy)], 1)
    uv_r = uv_l - np.stack([float(cam.fx) * float(cam.baseline_m) / p_cur[:, 2],
                            np.zeros(n)], 1)
    meas = (np.concatenate([uv_l, uv_r], 1)
            + 0.5 * rng.standard_normal((n, 4))).astype(np.float32)
    w = np.ones(n, np.float32)
    mask = np.ones(n, bool)
    T0 = np.eye(4, dtype=np.float32)
    for name, solve in (("stereo_uv_align", aligners.stereo_uv_align),
                        ("stereo_uv_align_fast", aligners.stereo_uv_align_fast)):
        def f(p, m, wt, mk, t, s=solve):
            return s(cam, aligners.StereoUVData(p_prev=p, meas=m, weight=wt), mk, t).x
        Td, Tc = run_on(dev, jax.jit(f), p_prev, meas, w, mask, T0), \
            run_on(ref, jax.jit(f), p_prev, meas, w, mask, T0)
        dt = float(np.linalg.norm(Td[:3, 3] - Tc[:3, 3]))
        # Small-angle rotation difference: |R1 - R2|_F = sqrt(2) * angle.
        dr = float(np.linalg.norm(Td[:3, :3] - Tc[:3, :3]) / np.sqrt(2.0))
        c.check(f"{name} pose card vs CPU", dt <= 1e-4 and dr <= 1e-5,
                f"|dt| {dt:.2e} m, |dR| {dr:.2e} rad")

    check_pose_graph(c, dev, ref, n_keyframes)


def check_pose_graph(c: Checks, dev, ref, P: int) -> None:
    """Hierarchical pose graph on the card against the CPU.  Its 10
    iterations do not converge, so the result carries f32 rounding
    forward; on this problem random 1-ulp changes of the inputs move the
    CPU result by at most ~2e-5 m, so 1e-3 m separates a port fault from
    rounding.  A 40 m circle with three times the noise is too sensitive
    for that: 1-ulp changes move it by ~2e-3 m."""
    from vslam_tpu.backend import pose_graph as pg

    est, odo, closures = pose_graph_problem(P)

    def pg_on(device):
        with jax.default_device(device):
            out, _ = pg.optimize_pose_graph_hierarchical(
                est, odo, np.ones(P - 1, np.float32), closures)
        return out

    gd, gc = pg_on(dev), pg_on(ref)
    d = float(np.max(np.linalg.norm(gd[:, :3, 3] - gc[:, :3, 3], axis=1)))
    c.check(f"pose graph {P} keyframes card vs CPU", d <= 1e-3, f"max |dt| {d:.2e} m")


def pose_graph_problem(P: int, seed: int = 3):
    """Two laps of a 10 m circle: drifted poses, noisy odometry (P-1) and
    a revisit closure every 4th keyframe of the first lap."""
    from vslam_tpu.io import synthetic
    from vslam_tpu.ops import lie

    rng = np.random.default_rng(seed)
    gt = synthetic.circle_trajectory(P, radius=10.0, laps=2.0)
    odo = np.einsum("kab,kbc->kac", np.linalg.inv(gt[:-1]), gt[1:]).astype(np.float32)
    for k in range(P - 1):
        e = (rng.standard_normal(6) * [3e-4, 3e-4, 3e-4, 3e-5, 3e-5, 3e-5]).astype(np.float32)
        odo[k] = odo[k] @ np.asarray(lie.exp_se3(jnp.asarray(e)))
    est = [np.eye(4, dtype=np.float32)]
    for k in range(P - 1):
        est.append(est[-1] @ odo[k])
    est = np.stack(est).astype(np.float32)
    half = P // 2
    closures = [(i, i + half, (np.linalg.inv(gt[i]) @ gt[i + half]).astype(np.float32))
                for i in range(0, P - half, 4)]
    return est, odo, closures


# ---------------------------------------------------------------------------
# Phases 2-4: the engine, the CLI, windowed BA
# ---------------------------------------------------------------------------


def run_engine(cam, cfg, frames, landmark_capacity=65536):
    """Frames through SlamEngine.process(); (trajectory, report, seconds)."""
    from vslam_tpu.system.engine import SlamEngine

    engine = SlamEngine(cam, cfg, landmark_capacity=landmark_capacity)
    t0 = time.perf_counter()
    for img_l, img_r in frames:
        engine.process(img_l, img_r)
    traj = engine.trajectory
    dt = time.perf_counter() - t0
    return traj, engine.report(), dt


def ate(traj, gt) -> float:
    from vslam_tpu.eval import trajectory as traj_eval

    return float(traj_eval.ate_rmse(np.asarray(traj), gt)[0])


def phase_closed_loop(c: Checks, cam, cfg, world, frames, card):
    traj, rep, dt = run_engine(cam, cfg, frames)
    e = ate(traj, world.poses)
    c.check("closed loop: closures", rep["n_closures"] > 0, str(rep["n_closures"]))
    c.check("closed loop: pose-graph optimizations", rep["n_optimizations"] > 0,
            str(rep["n_optimizations"]))
    c.check("closed loop: tracking breaks", rep["n_track_breaks"] == 0,
            str(rep["n_track_breaks"]))
    c.check("closed loop: ATE", e <= ATE_LIMIT_M, f"{e:.4f} m")
    # A second run of the same frames reuses every compiled program.
    _, _, dt2 = run_engine(cam, cfg, frames)
    print(f"closed loop frames/s on {card}: {len(frames) / dt2:.2f} "
          f"(second run; first run incl. compilation {len(frames) / dt:.2f})",
          flush=True)


def write_png_gray8(path: str, img: np.ndarray) -> None:
    """8-bit grayscale PNG with zlib, no imaging library."""
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_kitti_sequence(root: str, cam, frames, poses) -> str:
    """image_0/, image_1/, calib.txt, times.txt and gt.txt under root."""
    from vslam_tpu.eval import trajectory as traj_eval

    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i, (img_l, img_r) in enumerate(frames):
        for sub, img in (("image_0", img_l), ("image_1", img_r)):
            write_png_gray8(os.path.join(root, sub, f"{i:06d}.png"),
                            np.clip(np.round(img), 0, 255).astype(np.uint8))
    fx, fy, cx, cy = (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy))
    with open(os.path.join(root, "calib.txt"), "w") as f:
        for k, tx in (("P0", 0.0), ("P1", -fx * float(cam.baseline_m))):
            f.write(f"{k}: {fx} 0 {cx} {tx} 0 {fy} {cy} 0 0 0 1 0\n")
    np.savetxt(os.path.join(root, "times.txt"), 0.1 * np.arange(len(frames)))
    gt = os.path.join(root, "gt.txt")
    traj_eval.write_kitti(gt, poses)
    return gt


def phase_cli(c: Checks, cam, world, frames, n_frames=64):
    from vslam_tpu.system import cli

    with tempfile.TemporaryDirectory() as tmp:
        seq = os.path.join(tmp, "sequence")
        gt = write_kitti_sequence(seq, cam, frames[:n_frames], world.poses[:n_frames])
        est = os.path.join(tmp, "estimate_kitti.txt")
        cli.main(["run", "--dataset", seq, "-c", KITTI_CONFIG,
                  "--output-kitti", est,
                  "--timing-output", os.path.join(tmp, "timing.json")])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["eval", "--estimate", est, "--ground-truth", gt])
        res = json.loads(out.getvalue().strip().splitlines()[-1])
    c.check("CLI run on configuration_kitti.yaml: poses", res["n_poses"] == n_frames,
            str(res["n_poses"]))
    c.check("CLI eval: ATE", res["ate_rmse_m"] <= ATE_LIMIT_M, f"{res['ate_rmse_m']} m")


def phase_ba(c: Checks, cam, cfg, world, frames):
    cfg = copy.deepcopy(cfg)
    cfg.graph_optimization.enable_full_bundle_adjustment = True
    cfg.graph_optimization.number_of_frames_per_bundle_adjustment = 48
    traj, rep, _ = run_engine(cam, cfg, frames)
    e = ate(traj, world.poses)
    c.check("BA on: BA runs", rep["n_ba_runs"] > 0, str(rep["n_ba_runs"]))
    c.check("BA on: finite trajectory", bool(np.all(np.isfinite(traj))))
    c.check("BA on: ATE", e <= ATE_LIMIT_M, f"{e:.4f} m")


# ---------------------------------------------------------------------------
# --four-cards: the sharded paths against one card
# ---------------------------------------------------------------------------


def phase_sharded_kernels(c: Checks, n_dev=4, n_kf=16, n_lm=2048, n_db=45056,
                          n_query=1024):
    from vslam_tpu.backend import ba as ba_mod
    from vslam_tpu.ops import camera as cam_ops, hamming, lie
    from vslam_tpu.parallel import mesh as mesh_mod
    from vslam_tpu.parallel import sharded_ba, sharded_search

    mesh = mesh_mod.make_mesh(n_dev)
    one = jax.devices()[0]
    rng = np.random.default_rng(2)
    cam = kitti_camera()

    # Windowed-BA-sized problem: n_kf keyframes on a line, n_lm landmarks.
    T_gt = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    T_gt[:, 0, 3] = 0.3 * np.arange(n_kf)
    T_gt[:, 2, 3] = 0.5 * np.arange(n_kf)
    xyz = np.stack([rng.uniform(-8, 8, n_lm), rng.uniform(-3, 3, n_lm),
                    rng.uniform(8, 25, n_lm)], 1).astype(np.float32)
    O = 6
    obs_cam = np.stack([rng.choice(n_kf, size=O, replace=False) for _ in range(n_lm)])
    R_wc, t_wc = T_gt[obs_cam, :3, :3], T_gt[obs_cam, :3, 3]  # (L, O, ...)
    p = np.einsum("loji,loj->loi", R_wc, xyz[:, None, :] - t_wc)  # camera frame
    uv_l, uv_r, _ = cam_ops.project_stereo(cam, jnp.asarray(p.reshape(-1, 3)))
    obs_uv4 = np.concatenate([np.asarray(uv_l), np.asarray(uv_r)], 1)
    obs_uv4 = obs_uv4.reshape(n_lm, O, 4).astype(np.float32)
    obs_cam = obs_cam.astype(np.int32)
    obs_mask = np.ones((n_lm, O), bool)
    T_init = T_gt.copy()
    for k in range(1, n_kf):
        e = np.concatenate([rng.normal(0, 0.05, 3), rng.normal(0, 0.05 / 3, 3)])
        T_init[k] = T_gt[k] @ np.asarray(lie.exp_se3(jnp.asarray(e.astype(np.float32))))
    prob = ba_mod.BAProblem(
        T_wc=jnp.asarray(T_init),
        xyz=jnp.asarray(xyz + rng.normal(0, 0.3, xyz.shape).astype(np.float32)),
        obs_cam=jnp.asarray(obs_cam), obs_uv4=jnp.asarray(obs_uv4),
        obs_weight=jnp.ones((n_lm, O), jnp.float32), obs_mask=jnp.asarray(obs_mask),
        lm_valid=jnp.ones(n_lm, bool), cam_fixed=jnp.asarray(np.arange(n_kf) == 0),
    )
    cfg = ba_mod.BAConfig(iterations=10)
    with jax.default_device(one):
        T1 = np.asarray(jax.device_get(ba_mod.bundle_adjust(cam, jax.device_put(prob, one), cfg)[0]))
    T4 = np.asarray(jax.device_get(sharded_ba.bundle_adjust_sharded(cam, prob, mesh, cfg)[0]))
    d = float(np.max(np.linalg.norm(T4[:, :3, 3] - T1[:, :3, 3], axis=1)))
    c.check(f"sharded BA ({n_kf} kf x {n_lm} lm) vs one card", d <= 1e-3,
            f"max |dt| {d:.2e} m")

    db = rng.integers(0, 2**32, size=(n_db, 8), dtype=np.uint32)
    q = db[rng.choice(n_db, n_query, replace=False)].copy()
    q[: n_query // 2, 1] ^= np.uint32(0b111)
    valid = np.ones(n_db, bool)
    valid[: n_db // 16] = False

    def one_card(qq, dd, vv):
        dist = hamming.hamming_matrix_mxu(qq, dd)
        d1, i1 = hamming.min_encode(dist, vv[None, :], axis=1)
        cols = jax.lax.broadcasted_iota(jnp.int32, dist.shape, 1)
        d2, _ = hamming.min_encode(dist, vv[None, :] & (cols != i1[:, None]), axis=1)
        return i1, jnp.minimum(d1.astype(jnp.int32), 511), jnp.minimum(d2.astype(jnp.int32), 511)

    i1, d1, d2 = run_on(one, jax.jit(one_card), q, db, valid)
    idx, dist = jax.device_get(sharded_search.search_sharded(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(valid), mesh))
    c.check(f"search_sharded over {n_db} rows vs one card",
            np.array_equal(idx, i1) and np.array_equal(dist, d1))
    idx, s1, s2 = jax.device_get(sharded_search.search_sharded_top2(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(valid), mesh))
    c.check(f"search_sharded_top2 over {n_db} rows vs one card",
            np.array_equal(idx, i1) and np.array_equal(s1, d1) and np.array_equal(s2, d2))


def phase_sharded_engine(c: Checks, cam, cfg, world, frames, n_dev=4):
    runs = {}
    for sharded in (True, False):
        cf = copy.deepcopy(cfg)
        cf.parallelism.shard_descriptor_db = sharded
        cf.parallelism.shard_landmarks = sharded
        cf.parallelism.mesh_shape = (n_dev,)
        traj, rep, dt = run_engine(cam, cf, frames)
        runs[sharded] = (ate(traj, world.poses), rep["n_closures"], dt)
        print(f"  sharded={sharded}: ATE {runs[sharded][0]:.4f} m, "
              f"{rep['n_closures']} closures, {len(frames) / dt:.2f} frames/s", flush=True)
    c.check("sharded engine: closures fire", runs[True][1] > 0 and runs[False][1] > 0)
    c.check("sharded engine: same closure count", runs[True][1] == runs[False][1],
            f"{runs[True][1]} vs {runs[False][1]}")
    c.check("sharded engine: ATEs within 0.02 m",
            abs(runs[True][0] - runs[False][0]) <= 0.02)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on a 4-card mesh")
    args = ap.parse_args(argv)

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {backend!r}", file=sys.stderr)
        return 2
    n_dev = 4 if args.four_cards else 1
    if len(jax.devices()) < n_dev:
        print(f"chip_smoke: needs {n_dev} GPUs; JAX found {len(jax.devices())}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import bench

    card = bench.card_name_and_power_limit()
    print(f"{card}, jax {jax.__version__}", flush=True)

    from vslam_tpu.utils import compile_cache

    compile_cache.enable()
    jax.config.update("jax_default_matmul_precision", "highest")

    c = Checks()
    cam, cfg, world, frames = bench.make_closed_loop()
    if args.four_cards:
        c.phase("sharded kernels", phase_sharded_kernels, n_dev)
        c.phase("sharded closed loop", phase_sharded_engine, cam, cfg, world,
                frames, n_dev)
    else:
        c.phase("kernel parity", phase_kernels, jax.devices()[0],
                jax.devices("cpu")[0])
        c.phase("closed loop", phase_closed_loop, cam, cfg, world, frames, card)
        c.phase("CLI", phase_cli, cam, world, frames)
        c.phase("windowed BA", phase_ba, cam, cfg, world, frames)

    if c.failed:
        print("chip_smoke FAILED: " + "; ".join(c.failed), file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
