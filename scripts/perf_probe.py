"""Quick GPU perf probe: headline 128-frame closed-loop fps + pure
device-compute fps + stage table.  A fast-iteration subset of bench.py
(same config) for in-session optimization work — NOT a driver artifact.

Usage: python scripts/perf_probe.py [--no-closed-loop] [--repeat N]
"""

import copy
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

    from vslam_tpu.eval import trajectory as traj_eval
    from vslam_tpu.system.engine import SlamEngine
    from vslam_tpu.tracking.tracker import FusedPoseTracker
    from vslam_tpu.utils import log as log_mod

    import bench

    repeat = 1
    if "--repeat" in sys.argv:
        repeat = int(sys.argv[sys.argv.index("--repeat") + 1])

    t0 = time.perf_counter()
    cam, cfg, world, frames = bench.make_closed_loop()
    n_frames = len(frames)
    print(f"render: {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    # warm
    t0 = time.perf_counter()
    from vslam_tpu.backend import pose_graph as pg
    from vslam_tpu.loop import relocalizer as reloc_mod

    warm = SlamEngine(cam, copy.deepcopy(cfg), landmark_capacity=65536)
    wh = warm.tracker.prestage(frames)
    for h in wh:
        warm.process_prestaged(h)
    warm._flush_tracker()
    pg.warm_hierarchical_buckets()
    reloc_mod.warm_icp_batches(cfg.relocalization)
    del warm
    print(f"warm: {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    out = {}

    # device-only compute fps
    def device_only():
        tr = FusedPoseTracker(cam, copy.deepcopy(cfg), landmark_capacity=65536)
        th = tr.prestage(frames)
        tr._dispatch_staged(th[0])
        jax.block_until_ready(tr.state.T_world_cam)
        n = sum(h[1] for h in th[1:])
        t0 = time.perf_counter()
        for h in th[1:]:
            tr._dispatch_staged(h)
        jax.block_until_ready(tr.state.T_world_cam)
        dt = time.perf_counter() - t0
        return round(n / dt, 2), round(1e3 * dt / n, 3)

    out["device_fps"], out["device_ms_per_frame"] = device_only()

    if "--no-closed-loop" not in sys.argv:
        fps_list = []
        for rep in range(repeat):
            log_mod.chronometers.clear()
            engine = SlamEngine(cam, copy.deepcopy(cfg), landmark_capacity=65536)
            handles = engine.tracker.prestage(frames)
            t0 = time.perf_counter()
            for h in handles:
                engine.process_prestaged(h)
            engine._flush_tracker()
            dt = time.perf_counter() - t0
            fps_list.append(round(n_frames / dt, 2))
            if rep == repeat - 1:
                est = np.stack(engine.tracker.trajectory)
                rmse, _, _ = traj_eval.ate_rmse(est, world.poses)
                rep_d = engine.report()
                out["ate_rmse_m"] = round(float(rmse), 4)
                out["n_closures"] = rep_d["n_closures"]
                out["n_local_maps"] = rep_d["n_local_maps"]
                stage_ms = {
                    k: round(1e3 * v["seconds"] / n_frames, 3)
                    for k, v in rep_d["stage_table"].items()
                }
                stage_ms["frame_step_dispatch"] = round(
                    1e3 * rep_d["stage_seconds"].get("frame_step", 0.0)
                    / n_frames, 3,
                )
                out["stage_ms_per_frame"] = stage_ms
        out["closed_loop_fps"] = fps_list

    print(json.dumps(out))


if __name__ == "__main__":
    main()
