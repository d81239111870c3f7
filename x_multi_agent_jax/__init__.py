"""x_multi_agent_jax: collaborative visual-inertial odometry in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the X library
(jpl-x/x_multi_agent): single- and multi-agent vision-based navigation with
multi-sensor fusion (thermal, range, solar, inertial).

Design stance (accelerator-first):
  * fixed shapes everywhere — sliding windows, track slots, and agent counts
    are static; list churn in the reference becomes masks + slot indices
  * the filter is a pure function (FilterState, Measurement) -> FilterState
    driven by lax.scan; agents are a vmapped / shard_mapped batch dimension
  * hot linear algebra (covariance propagation, Jacobian stacking, QR
    compression) is fused on-device; the LK tracker is a Pallas kernel on
    the GPU (Triton route), the rest of the vision front end is left to XLA
"""

__version__ = "0.1.0"
