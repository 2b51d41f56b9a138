"""vslam_tpu — an accelerator-native stereo/RGB-D visual SLAM framework.

Built from scratch in JAX/XLA as a ground-up redesign of the
capabilities of the ProSLAM-derived reference
(Ssellu/vslam-pose-estimation-framework): feature-based front-end,
projective Gauss-Newton pose tracking, landmark mapping, keyframe/local-map
generation, Hamming-search loop closure with ICP verification, and a
pose-graph / sharded Schur-complement bundle-adjustment back-end.

Layer map (mirrors reference layers, see SURVEY.md §1, but as array programs):
  ops/       core math kernels: SE(3), camera models, packed-descriptor Hamming
  solve/     the generic Gauss-Newton engine + its aligner instantiations
  frontend/  detection (FAST), description (ORB), stereo + projective matching
  mapping/   frame state, landmark table, local maps, world map
  tracking/  per-frame odometry state machine (host) driving jitted kernels
  loop/      loop-closure: descriptor database search + geometric verification
  backend/   pose-graph optimization and Schur-complement bundle adjustment
  parallel/  device mesh, sharded BA, sharded Hamming search (XLA collectives)
  io/        dataset loaders (KITTI/EuRoC/TUM), trajectory writers, config
  eval/      ATE/RPE trajectory evaluation (trajectory_analyzer parity)
  system/    SlamEngine orchestration + CLI
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry code (SE(3) composition, 6x6 normal equations, projections)
# needs full f32: by default a GPU may run f32 matmuls and convolutions in
# TF32, which keeps a 10-bit mantissa.  All large matmuls in this framework
# are integer (packed-descriptor Hamming), which this setting does not
# touch, so force full f32 everywhere.
_jax.config.update("jax_default_matmul_precision", "highest")
