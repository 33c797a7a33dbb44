"""vloam_tpu — a JAX visual-lidar odometry and mapping engine for the GPU.

A from-scratch JAX/XLA/Pallas re-design of the VLOAM pipeline (reference:
liuzm-slam/VLOAM-NOTED, a ROS1/C++/Ceres/PCL stack).  Nothing here is a
translation: callbacks become pure scan-step functions over pytree state,
Ceres autodiff + DENSE_QR becomes batched Gauss-Newton with forward-mode
Jacobians, kd-trees become brute-force nearest-neighbour sweeps, and the
rolling voxel-cube map becomes a fixed-shape block-cyclic cube grid that
shards across a device mesh.

Layer map (mirrors SURVEY.md §1 of the reference):
  L5 driver      : vloam_tpu.runtime (CLI / frame loop / export)
  L4a VO         : vloam_tpu.models.visual_odometry
  L4b LO + MO    : vloam_tpu.models.lidar_odometry, .laser_mapping
  L3 frame graph : vloam_tpu.models.frame_graph (the vloam_tf equivalent)
  L2 solvers     : vloam_tpu.ops.{lidar_factors, vo_factors, gauss_newton}
  L1 substrate   : JAX/XLA/Pallas + vloam_tpu.ops.{knn, voxel, image_ops, ...}
"""

__version__ = "0.1.0"

import jax as _jax

# This is a metric-scale geometry engine, not a neural net: matmuls carry
# pixel coordinates (~1e3), world-frame points (km after long drives), and
# Gauss-Newton normal equations.  On the GPU an f32 matmul may otherwise run
# in TF32 (10-bit mantissa), losing ~|value|^2 * 2^-11 per product — square
# metres in the k-NN distances at +-60 m coordinates, which reorders
# neighbours (bf16 measured: 67 m^2 error, 0.81 recall@5; ops/knn.py).
# "highest" keeps every f32 matmul in full f32; tolerant hot spots (the KLT
# window resampling, descriptor sampling) opt down to explicit bf16
# operands at the call site.
_jax.config.update("jax_default_matmul_precision", "highest")

from vloam_tpu.config import VloamConfig  # noqa: F401
