"""isaacgymenvs_ma_tpu_torch — PyTorch + CUDA port of isaacgymenvs_ma_tpu.

The JAX package ``isaacgymenvs_ma_tpu`` is the reference; this package mirrors
its module paths (``physics/engine.py``, ``physics/dyn_kernel.py``,
``tasks/ant.py`` ...) so each counterpart is easy to find.  It imports
``torch`` and never ``jax``, and nothing of the JAX package: it keeps its own
copies of the numpy-only modules it needs (``models``, ``utils.config``).

Every Pallas TPU kernel on a ported path has a hand-written CUDA kernel here
(``physics/csrc``) beside a plain PyTorch twin; a wrapper runs the twin only
for CPU tensors and the kernel for CUDA tensors.
"""
__version__ = "0.1.0"
