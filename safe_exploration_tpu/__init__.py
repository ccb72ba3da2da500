"""safe_exploration_tpu — a safe model-based RL / safe-MPC framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of the reference library
``befelix/safe-exploration`` (Koller, Berkenkamp, Turchetta, Krause — "Learning-based
Model Predictive Control for Safe Exploration", CDC 2018 / arXiv:1906.12189).

Where the reference triplicates its math core (numpy eager / CasADi symbolic /
PyTorch batched — see SURVEY.md §1), this framework has ONE pure-functional JAX
implementation that is simultaneously eager, jit-traceable, differentiable
(``jax.jacfwd`` / ``custom_vjp``) and batchable (``vmap`` / ``shard_map``).

Layer map (mirrors SURVEY.md §1):
  L1 math core      -> :mod:`safe_exploration_tpu.ops`
  L2 dynamics + reachability -> :mod:`safe_exploration_tpu.models`,
                                :mod:`safe_exploration_tpu.reachability`
  L3 safe-MPC solvers        -> :mod:`safe_exploration_tpu.solvers`
  L4 experiment runtime      -> :mod:`safe_exploration_tpu.runtime`
  parallel scale-out         -> :mod:`safe_exploration_tpu.parallel`
"""

__version__ = "0.1.0"

# --- numerics policy: f32-accurate matmuls ---------------------------------
#
# On an NVIDIA GPU, jax's DEFAULT matmul precision lets float32 products run
# on the tensor cores in TF32 (10-bit mantissa). This library's SAFETY math
# runs through matmuls — RBF Gram distances, the solve-free posterior-variance
# quadratic forms (kzz - kv K^-1 kv), ellipsoid affine images H Q H^T — and
# reduced-precision products there silently corrupt predictive variances and
# inflate the tubes (chip_smoke.py checks the f32 refit against f64 at a
# bound TF32 would exceed). The tubes are a CORRECTNESS guarantee, so
# f32-accurate matmuls are the package default; their cost on the GPU is not
# measured yet. Opt out (e.g. for throughput experiments on non-safety paths)
# with SAFE_EXPLORATION_TPU_MATMUL_PRECISION=default.
import os as _os

import jax as _jax

_prec = _os.environ.get("SAFE_EXPLORATION_TPU_MATMUL_PRECISION", "highest")
if _prec != "default":
    _jax.config.update("jax_default_matmul_precision", _prec)
del _os, _jax, _prec
