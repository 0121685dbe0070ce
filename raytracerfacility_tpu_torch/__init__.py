"""PyTorch/CUDA port of ``raytracerfacility_tpu``.

The JAX package beside this one is the reference; every module here names
its reference counterpart. This package imports ``torch`` and numpy, never
``jax``, ``flax`` or ``raytracerfacility_tpu``.

Covered so far: the camera path tracer for scenes of triangles and
analytic curves with Default and MLVQ CompressedBTF materials (``mlvq/``,
``ops/btf.py``) under a flat, cubemap or Nishita-sky environment or
SingleLightSource lighting (``models/pathtracer.py``), the camera facade,
the denoiser and LiDAR (``models/``), the illumination estimator
(``models/illumination.py``), shared-geometry instancing (``ops/inst.py``)
and the LBVH (``ops/bvh.py``, ``ops/traverse.py``), with every kernel
written in CUDA C++ for Hopper (``csrc/``). Features outside that
envelope raise ``NotImplementedError``.
"""
