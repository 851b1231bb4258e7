"""coxgraph_tpu — collaborative dense SLAM framework on JAX/XLA.

A brand-new JAX/XLA/Pallas framework providing the capabilities of the
reference coxgraph system (multi-robot collaborative dense scene
reconstruction; see /root/reference and SURVEY.md): per-robot TSDF/ESDF
submap integration from RGB-D frames, feature-based loop-closure candidates,
submap-to-submap dense registration, and a client-server global pose graph
solved by Gauss-Newton — producing a globally consistent mesh and
trajectories for N robots.

Design stance (SURVEY.md §7): arrays, not callbacks. Every reference ROS
node is a pure function over pytrees; every topic/service is an in-XLA
collective or a host-side queue; every Ceres solve is a batched Gauss-Newton
in JAX; every voxblox integrator is a fused XLA/Pallas kernel over
block-sparse voxel arrays held in fixed-capacity pools.

Subpackages
-----------
core      : SE(3) geometry, block-sparse voxel storage, submap containers
ops       : compute kernels — TSDF integration, ESDF propagation,
            marching cubes, layer merge, registration residuals, features
mapper    : per-robot frontend (submap chaining, local pose graph, map server)
solver    : batched Gauss-Newton / LM pose-graph optimizer
server    : fusion coordinator (timelines, map fusion, client alignment)
parallel  : mesh/sharding layer — multi-robot SPMD over jax.sharding.Mesh
frontends : synthetic RGB-D scene rendering and dataset replay
eval      : ATE/RMSE metrics, PLY export, timing/bandwidth counters
utils     : config system, logging, checkpointing
"""

__version__ = "0.1.0"
