"""Stage-level profile of the closed-loop engine (bench.py workload).

Runs the same circular-trajectory closed loop as bench.py and prints the
engine report (stage table + counters) plus a per-frame time histogram, so
keyframe-path regressions show up as named stages instead of a single fps
number.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    from vslam_tpu.utils import compile_cache

    compile_cache.enable()

    from vslam_tpu.io import synthetic
    from vslam_tpu.io.config import ParameterCollection
    from vslam_tpu.ops import camera as cam_ops
    from vslam_tpu.eval import trajectory as traj_eval
    from vslam_tpu.system.engine import SlamEngine
    import bench

    cam = cam_ops.make_camera(fx=718.856, fy=718.856, cx=607.19, cy=185.22,
                              baseline_m=0.5372, rows=376, cols=1241)
    cfg = ParameterCollection()
    cfg.framepoint_generation.capacity = 1024
    cfg.framepoint_generation.bin_size_pixels = 16
    cfg.world_map.minimum_distance_traveled_for_local_map = 1.5
    cfg.world_map.minimum_number_of_frames_for_local_map = 3
    cfg.relocalization.preliminary_minimum_interspace_queries = 8
    cfg.relocalization.preliminary_minimum_matching_ratio = 0.08
    cfg.relocalization.icp_minimum_number_of_inliers = 10
    cfg.relocalization.icp_minimum_inlier_ratio = 0.3
    # Snapshot row width: ~200-400 landmarks are live per keyframe at this
    # cadence, so 512 columns hold them and halve each drained row.
    cfg.local_map.maximum_number_of_landmarks = 512

    n_frames = 128
    poses = synthetic.circle_trajectory(n_frames, radius=13.0)
    world = synthetic.make_world(cam, n_points=7000, seed=0, poses=poses)
    frames = [synthetic.render_frame(world, t)[:2] for t in range(n_frames)]

    warm = SlamEngine(cam, cfg)
    wh = warm.tracker.prestage(frames)
    for h in wh:
        warm.process_prestaged(h)
    warm._flush_tracker()
    bench.warm_pose_graph_buckets()
    del warm

    from vslam_tpu.utils import log
    log.chronometers.clear()

    engine = SlamEngine(cam, cfg)
    handles = engine.tracker.prestage(frames)
    t0 = time.perf_counter()
    per_chunk = []
    for h in handles:
        tc = time.perf_counter()
        engine.process_prestaged(h)
        per_chunk.append(time.perf_counter() - tc)
    engine._flush_tracker()
    dt = time.perf_counter() - t0
    rep = engine.report()
    est = np.stack(engine.tracker.trajectory)
    rmse, _, _ = traj_eval.ate_rmse(est, world.poses)

    print(json.dumps({
        "fps": round(n_frames / dt, 2),
        "total_s": round(dt, 3),
        "ate_rmse_m": round(float(rmse), 4),
        "n_local_maps": rep["n_local_maps"],
        "n_closures": rep["n_closures"],
        "stage_seconds": rep["stage_seconds"],
        "stage_table": rep["stage_table"],
        "chunk_ms": [round(1e3 * t, 1) for t in per_chunk],
    }, indent=2))


if __name__ == "__main__":
    main()
