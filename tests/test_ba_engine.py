"""Full bundle adjustment wired into the live engine (reference
addPoseWithFactors + optimizeFactorGraph, graph_optimizer.cpp:319-488):
windowed BA runs on keyframe cadence, back-propagates poses + landmarks,
and does not degrade the trajectory."""

import numpy as np
import pytest

from vslam_tpu.eval import trajectory as traj_eval
from vslam_tpu.io import synthetic
from vslam_tpu.io.config import ParameterCollection
from vslam_tpu.ops import camera as cam_ops
from vslam_tpu.system.engine import SlamEngine

CAM = cam_ops.make_camera(fx=400.0, fy=400.0, cx=160.0, cy=80.0,
                          baseline_m=0.3, rows=160, cols=320)



import pytest

# Full-engine / compile-heavy: excluded from the fast core subset
pytestmark = pytest.mark.slow

def make_cfg(ba: bool):
    cfg = ParameterCollection()
    cfg.framepoint_generation.capacity = 256
    cfg.framepoint_generation.bin_size_pixels = 10
    cfg.local_map.minimum_number_of_landmarks = 20
    cfg.world_map.minimum_distance_traveled_for_local_map = 0.6
    cfg.world_map.minimum_number_of_frames_for_local_map = 2
    cfg.command_line.option_disable_relocalization = True  # isolate BA
    cfg.graph_optimization.enable_full_bundle_adjustment = ba
    cfg.graph_optimization.number_of_frames_per_bundle_adjustment = 8
    return cfg


@pytest.fixture(scope="module")
def world_frames():
    world = synthetic.make_world(CAM, n_frames=36, n_points=2500, seed=8,
                                 step=0.4, turn_rate=0.004)
    frames = [synthetic.render_frame(world, t)[:2] for t in range(36)]
    return world, frames


def run(world_frames, ba: bool):
    world, frames = world_frames
    eng = SlamEngine(CAM, make_cfg(ba), landmark_capacity=16384)
    for l, r in frames:
        eng.process(l, r)
    eng._flush_tracker()
    est = np.stack(eng.tracker.trajectory)
    rmse, _, _ = traj_eval.ate_rmse(est, world.poses)
    return eng, float(rmse)


def test_ba_runs_and_stays_accurate(world_frames):
    eng_ba, rmse_ba = run(world_frames, ba=True)
    eng_no, rmse_no = run(world_frames, ba=False)
    assert eng_ba.n_ba_runs >= 1, "BA never ran in the live engine"
    assert eng_no.n_ba_runs == 0
    # BA must keep (or improve) accuracy on this clean sequence.
    assert rmse_ba < max(1.2 * rmse_no, 0.05), (rmse_ba, rmse_no)
    # Landmarks stay finite after write-back.
    t = eng_ba.tracker.table
    xyz = np.asarray(t.xyz_w)[np.asarray(t.valid)]
    assert np.all(np.isfinite(xyz))


def test_ba_problem_construction(world_frames):
    """The window problem groups per-landmark observations from keyframe
    snapshots with >= 2 sightings."""
    from vslam_tpu.system import ba_runner

    eng, _ = run(world_frames, ba=False)
    built = ba_runner.build_window_problem(eng)
    assert built is not None
    prob, kf_ids, slot_arr, n_lm = built
    assert n_lm >= 16
    om = np.asarray(prob.obs_mask)[:n_lm]
    assert (om.sum(1) >= 2).all()
    # Observation uv4 reprojects near the snapshot keyframe prediction.
    assert np.asarray(prob.obs_uv4)[:n_lm][om].max() < 400.0


def test_ba_with_device_archived_observations(world_frames):
    """Slim-drain mode: observations stay in the device keyframe archive
    and BA fetches its window's blocks lazily (ba_runner._fetch_archived_uv4)
    — same accuracy as the shipped-uv4 path up to the 1/16-px transfer
    quantization."""
    world, frames = world_frames
    eng = SlamEngine(CAM, make_cfg(True), landmark_capacity=16384)
    eng.tracker._ship_uv4 = False  # force archive mode (the accelerator default)
    for l, r in frames:
        eng.process(l, r)
    eng._flush_tracker()
    assert eng.n_ba_runs >= 1
    # The lazy fetch populated (and cached) the window maps' observations.
    fetched = [m for m in eng.world_map.local_maps if m.uv4 is not None]
    assert fetched, "archive fetch never populated uv4"
    est = np.stack(eng.tracker.trajectory)
    rmse, _, _ = traj_eval.ate_rmse(est, world.poses)
    assert rmse < 0.1, rmse
