"""Command-line interface.

Replaces the reference executables (executables/app.cpp CLI with its ~15
flags, parameters.cpp:182-270; trajectory_analyzer; trajectory_converter)
with subcommands:

  run       SLAM over a dataset -> trajectory files + report
            (app.cpp:6-146 parity: -c, -open-loop, -equalize-histogram,
            -save-pose-graph, -drop-framepoints flags)
  eval      ATE/RPE of an estimate vs ground truth
            (trajectory_analyzer.cpp parity)
  convert   trajectory/pose-graph format conversion
            (trajectory_converter.cpp parity)
  bench     per-stage benchmark on synthetic data

Usage: python -m vslam_tpu <subcommand> ...
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def write_engine_factor_graph(engine, path: str) -> None:
    """Assemble the FULL factor graph (poses + landmarks + measurement
    edges) from a finished engine and export it (writePoseGraphToFile
    parity, graph_optimizer.cpp:164-262)."""
    from vslam_tpu.io import g2o_io

    gopt = engine.cfg.graph_optimization
    poses = np.stack(engine.kf_poses)
    odometry = [
        (k - 1, k, engine.kf_odometry[k - 1], engine.kf_odom_weight[k - 1])
        for k in range(1, len(engine.kf_poses))
    ] + [(i, j, T, 10.0) for (i, j, T) in engine.closure_edges]
    landmark_xyz: dict = {}
    observations = []
    for m in engine.world_map.local_maps:
        T = m.T_world_kf
        slots = np.asarray(m.landmark_slots)
        xyz_kf = np.asarray(m.xyz_kf)
        for row in range(len(slots)):
            slot = int(slots[row])
            p_kf = xyz_kf[row].astype(np.float64)
            if slot not in landmark_xyz:
                landmark_xyz[slot] = T[:3, :3] @ p_kf + T[:3, 3]
            # 1/depth information (reference _setPointEdge
            # information_factor_, graph_optimizer.cpp:232).
            observations.append(
                (m.map_id, slot, p_kf, 1.0 / max(float(p_kf[2]), 0.1))
            )
    g2o_io.write_factor_graph(
        path, poses, odometry, landmark_xyz, observations,
        identifier_space=gopt.identifier_space,
        base_information_frame=gopt.base_information_frame,
        free_translation_for_poses=gopt.free_translation_for_poses,
        base_information_frame_factor_for_translation=(
            gopt.base_information_frame_factor_for_translation
        ),
    )


def cmd_run(args):
    from vslam_tpu.io import datasets
    from vslam_tpu.io.config import load_config
    from vslam_tpu.eval import trajectory as traj_eval
    from vslam_tpu.system.engine import SlamEngine

    cfg = load_config(args.config) if args.config else None
    if cfg is None:
        from vslam_tpu.io.config import ParameterCollection

        cfg = ParameterCollection()
    if args.open_loop:
        cfg.command_line.option_disable_relocalization = True
    if args.tracker_mode:
        cfg.command_line.tracker_mode = args.tracker_mode
    if args.depth_mode:
        cfg.command_line.tracker_mode = "RGB_DEPTH"
    if args.use_odometry:
        cfg.command_line.option_use_odometry = True
        cfg.tracking.motion_model = "CAMERA_ODOMETRY"
    if args.drop_framepoints is not None:
        cfg.command_line.option_drop_framepoints = args.drop_framepoints
    if args.recover_landmarks is not None:
        cfg.command_line.option_recover_landmarks = args.recover_landmarks
    if args.disable_bundle_adjustment:
        cfg.graph_optimization.enable_full_bundle_adjustment = False
    if args.dump:
        cfg.visualization.enable_image_dump = True
        if args.dump is not True:
            cfg.visualization.dump_directory = args.dump
    cfg.command_line.configuration_file_name = args.config or ""
    if not args.dataset:
        args.dataset = cfg.command_line.dataset_file_name
        if not args.dataset:
            raise SystemExit(
                "no dataset: pass --dataset or set "
                "command_line.dataset_file_name in the config"
            )

    ds_kwargs = {}
    equalize = (
        args.equalize_histogram or cfg.command_line.option_equalize_histogram
    )
    if equalize and args.format == "kitti":
        ds_kwargs["equalize_hist"] = True
    # Honor an explicitly-configured depth scale (reference
    # depth_scale_factor_intensity_to_meters, parameters.h:251); PNG
    # datasets otherwise keep the TUM 1/5000 convention.
    if args.format in ("tum", "icl") and (
        "framepoint_generation.depth_scale_factor_intensity_to_meters"
        in getattr(cfg, "explicit_keys", ())
    ):
        ds_kwargs["depth_scale"] = (
            cfg.framepoint_generation.depth_scale_factor_intensity_to_meters
        )
    ds = datasets.load_dataset(args.dataset, args.format, **ds_kwargs)
    if args.format in ("tum", "icl"):
        cfg.command_line.tracker_mode = "RGB_DEPTH"

    engine = SlamEngine(ds.cam, cfg)
    n = len(ds) if args.max_frames is None else min(len(ds), args.max_frames)
    timestamps = []
    from vslam_tpu.utils import log as log_mod

    trace = log_mod.device_trace(args.trace_dir)
    trace.__enter__()
    for frame in ds:
        if frame.index >= n:
            break
        engine.process(frame.img_left, frame.img_right)
        timestamps.append(frame.timestamp)
        if frame.index % 50 == 0:
            # report_lite: the full report() drains the device pipeline
            # (engine._flush_tracker) and would stall the run at every
            # status line — the reference's status line is free
            # (slam_assembly.cpp:453-477).
            rep = engine.report_lite()
            print(
                f"frame {frame.index}/{n} | {rep['mean_frame_hz']:.1f} Hz | "
                f"landmarks {rep['n_landmarks']} | local maps {rep['n_local_maps']} | "
                f"closures {rep['n_closures']}",
                file=sys.stderr,
            )

    trace.__exit__(None, None, None)
    est = engine.trajectory
    if args.output_kitti:
        traj_eval.write_kitti(args.output_kitti, est)
    if args.output_tum:
        traj_eval.write_tum(args.output_tum, est, np.asarray(timestamps))
    save_pg = args.save_pose_graph or (
        "pose_graph.g2o" if cfg.command_line.option_save_pose_graph else None
    )
    if save_pg and engine.kf_poses:
        from vslam_tpu.io import g2o_io

        edges = [
            (k - 1, k, engine.kf_odometry[k - 1], engine.kf_odom_weight[k - 1])
            for k in range(1, len(engine.kf_poses))
        ] + [(i, j, T, 10.0) for (i, j, T) in engine.closure_edges]
        g2o_io.write_pose_graph(save_pg, np.stack(engine.kf_poses), edges)
    if args.save_factor_graph and engine.kf_poses:
        from vslam_tpu.io import g2o_io

        write_engine_factor_graph(engine, args.save_factor_graph)
    if cfg.visualization.enable_image_dump:
        from vslam_tpu.viz import plots

        out = plots.dump_run(engine, cfg.visualization.dump_directory)
        print(f"visualization artifacts in {out}", file=sys.stderr)
    engine.print_report()
    with open(args.timing_output, "w") as f:
        json.dump(engine.report(), f, indent=2)


def cmd_eval(args):
    from vslam_tpu.eval import trajectory as traj_eval

    if args.format == "kitti":
        est = traj_eval.read_kitti(args.estimate)
        gt = traj_eval.read_kitti(args.ground_truth)
    else:
        ts_e, est = traj_eval.read_tum(args.estimate)
        ts_g, gt = traj_eval.read_tum(args.ground_truth)
        ia, ib = traj_eval.associate_timestamps(ts_e, ts_g, args.max_dt)
        est, gt = est[ia], gt[ib]
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    rmse, _, raw = traj_eval.ate_rmse(est, gt, with_scale=args.scale)
    t_rpe, r_rpe = traj_eval.rpe(est, gt)
    print(json.dumps({
        "ate_rmse_m": round(rmse, 4),
        "ate_rmse_raw_m": round(raw, 4),
        "rpe_trans_m": round(t_rpe, 4),
        "rpe_rot_rad": round(r_rpe, 4),
        "n_poses": int(n),
    }))


def cmd_convert(args):
    from vslam_tpu.eval import trajectory as traj_eval
    from vslam_tpu.io import g2o_io

    if args.input_format == "tum":
        _, poses = traj_eval.read_tum(args.input)
    elif args.input_format == "g2o":
        poses, _ = g2o_io.read_pose_graph(args.input)
    else:
        poses = traj_eval.read_kitti(args.input)
    if args.output_format == "kitti":
        traj_eval.write_kitti(args.output, poses)
    else:
        traj_eval.write_tum(args.output, poses)
    print(f"converted {len(poses)} poses -> {args.output}")


def cmd_bench(args):
    import bench as bench_mod  # repo-root bench.py

    bench_mod.main()


def main(argv=None):
    from vslam_tpu.utils import compile_cache

    compile_cache.enable()

    p = argparse.ArgumentParser(prog="vslam_tpu", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("run", help="run SLAM over a dataset")
    pr.add_argument("--dataset", default=None,
                    help="dataset path (or command_line.dataset_file_name)")
    pr.add_argument("--format", default="kitti", choices=["kitti", "euroc", "tum", "icl"])
    pr.add_argument("-c", "--config", default=None, help="YAML configuration file")
    pr.add_argument("--open-loop", action="store_true",
                    help="disable relocalization (reference -open-loop)")
    pr.add_argument("--equalize-histogram", action="store_true")
    pr.add_argument("--tracker-mode", choices=["RGB_STEREO", "RGB_DEPTH"], default=None)
    pr.add_argument("--max-frames", type=int, default=None)
    pr.add_argument("--output-kitti", default="trajectory_kitti.txt")
    pr.add_argument("--output-tum", default=None)
    pr.add_argument("--save-pose-graph", default=None,
                    help="write g2o pose graph (reference -save-pose-graph)")
    pr.add_argument("--save-factor-graph", default=None,
                    help="write FULL g2o factor graph: poses + landmark "
                         "vertices + measurement edges "
                         "(writePoseGraphToFile parity)")
    pr.add_argument("--timing-output", default="timing_vslam_tpu.json",
                    help="machine-readable report (timing_proslam.txt parity)")
    pr.add_argument("--dump", nargs="?", const=True, default=False,
                    metavar="DIR",
                    help="dump per-keyframe overlays + final map plot "
                         "(optional output directory; default from the "
                         "visualization config group)")
    # Remaining reference app flags (parameters.cpp:14-27 banner):
    pr.add_argument("--depth-mode", action="store_true",
                    help="RGB-D tracking (reference -dm; same as "
                         "--tracker-mode RGB_DEPTH)")
    pr.add_argument("--use-odometry", action="store_true",
                    help="use external odometry instead of the inner "
                         "motion model (reference -uo); requires a "
                         "dataset with per-frame odometry")
    pr.add_argument("--drop-framepoints", dest="drop_framepoints",
                    action="store_true", default=None,
                    help="recycle stale landmark slots at runtime "
                         "(reference -df; on by default here)")
    pr.add_argument("--no-drop-framepoints", dest="drop_framepoints",
                    action="store_false",
                    help="keep every landmark slot live (unbounded map)")
    pr.add_argument("--recover-landmarks", dest="recover_landmarks",
                    action="store_true", default=None,
                    help="re-acquire lost landmarks at solved-pose "
                         "projections (reference -rl; on by default)")
    pr.add_argument("--no-recover-landmarks", dest="recover_landmarks",
                    action="store_false")
    pr.add_argument("--disable-bundle-adjustment", action="store_true",
                    help="force periodic full BA off (reference -dba)")
    pr.add_argument("--trace-dir", default=None,
                    help="write an xprof device trace (easy_profiler parity)")
    pr.set_defaults(func=cmd_run)

    pe = sub.add_parser("eval", help="ATE/RPE evaluation")
    pe.add_argument("--estimate", required=True)
    pe.add_argument("--ground-truth", required=True)
    pe.add_argument("--format", default="kitti", choices=["kitti", "tum"])
    pe.add_argument("--scale", action="store_true", help="align with scale (monocular)")
    pe.add_argument("--max-dt", type=float, default=0.02)
    pe.set_defaults(func=cmd_eval)

    pc = sub.add_parser("convert", help="trajectory format conversion")
    pc.add_argument("--input", required=True)
    pc.add_argument("--input-format", default="tum", choices=["tum", "kitti", "g2o"])
    pc.add_argument("--output", required=True)
    pc.add_argument("--output-format", default="kitti", choices=["kitti", "tum"])
    pc.set_defaults(func=cmd_convert)

    pb = sub.add_parser("bench", help="synthetic benchmark")
    pb.set_defaults(func=cmd_bench)

    args = p.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
