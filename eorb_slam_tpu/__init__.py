"""eorb_slam_tpu — a JAX event-based visual-inertial SLAM engine.

Brand-new implementation with the capabilities of the reference EORB_SLAM
(ORB-SLAM3 + DAVIS event front-end, see SURVEY.md), re-designed for
accelerators programmed through XLA:

- fixed-capacity tensor map state instead of pointer graphs,
- one masked Gauss-Newton/LM optimizer with Schur landmark elimination
  instead of the g2o/Ceres recipe zoo,
- batched/vmapped front-end kernels (FAST, rBRIEF, Hamming matching,
  event splatting, motion-compensated images) instead of OpenCV loops,
- host orchestration + async dispatch instead of 9 mutex-coupled threads.
"""

import jax as _jax

# Geometry/optimizer math needs true float32 products. On an NVIDIA GPU the
# default precision lets XLA run float32 matmuls as TF32 (about three
# decimal digits), which breaks rotation orthonormality and the GN/LM
# solves, so every float32 product in the process runs at "highest".
# chip_smoke.py checks so3_exp orthonormality on the card.
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
