"""PyTorch + CUDA port of climt_tpu's fused moist GCM.

The package mirrors ``climt_tpu``'s layout (``core/``, ``ops/``,
``dycore/``, ``components/rrtmg/``) module for module, so that every
ported function has one JAX counterpart to be tested against.  It imports
``torch`` and never ``jax`` or ``climt_tpu``; constants and numpy-only
helpers it needs from the JAX package are copied with their source line
named beside them, and the RRTMG tables are read by path (``data.py``).

The two radiation kernels that the JAX package writes in Pallas are
hand-written CUDA here (``csrc/``), built with ``nvcc`` for ``sm_90a`` at
first use (``_build.py``).  Importing the package compiles nothing.

Entry point: ``climt_tpu_torch.dycore.moist_gcm.build_moist_gcm``.
"""
