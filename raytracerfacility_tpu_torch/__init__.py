"""PyTorch/CUDA port of ``raytracerfacility_tpu``.

The JAX package beside this one is the reference; every module here names
its reference counterpart. This package imports ``torch`` and numpy, never
``jax``, ``flax`` or ``raytracerfacility_tpu``.

Covered so far: the camera path tracer for triangle scenes with Default
materials under a flat Scene environment (``models/pathtracer.py``), with
its two kernels written in CUDA C++ for Hopper (``csrc/``): the per-segment
trace+shade kernel (``ops/seg.py``) and the whole-path kernel
(``ops/fused.py``). Features outside that envelope raise
``NotImplementedError``.
"""
