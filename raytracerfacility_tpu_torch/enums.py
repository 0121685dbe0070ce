"""Enumerations mirroring the reference's public enums.

Port of ``raytracerfacility_tpu/enums.py`` (all of it, unchanged values).
Parity: reference ``include/RayTracerFacility/RayTracer/Enums.hpp:4-24``,
``RayTracer.hpp:26-28`` (OutputType), ``RayTracer.hpp:99-101``
(EnvironmentalLightingType), ``RayTracer.hpp:177-179`` (RayType).

These are plain ``IntEnum`` so they can be used both as static (Python-level)
configuration and as integer codes in material/geometry tables.
"""

import enum


class MaterialType(enum.IntEnum):
    DEFAULT = 0
    VERTEX_COLOR = 1
    COMPRESSED_BTF = 2


class RendererType(enum.IntEnum):
    DEFAULT = 0
    INSTANCED = 1
    SKINNED = 2
    CURVE = 3


class GeometryType(enum.IntEnum):
    CUSTOM = 0
    QUADRATIC_BSPLINE = 1
    CUBIC_BSPLINE = 2
    LINEAR = 3
    CATMULL_ROM = 4
    TRIANGLE = 5


class OutputType(enum.IntEnum):
    COLOR = 0
    NORMAL = 1
    ALBEDO = 2
    DEPTH = 3


class EnvironmentalLightingType(enum.IntEnum):
    SCENE = 0
    SKYDOME = 1
    SINGLE_LIGHT_SOURCE = 2


class RayType(enum.IntEnum):
    """The reference keeps two hardware ray types (radiance + the BSSRDF's
    spatial-sampling probe, ``RayTracer.hpp:177-179``). The port has no SBT,
    but the enum is kept for API parity and for tagging ray pools.
    """

    RADIANCE = 0
    SPACIAL_SAMPLING = 1


class CurveMode(enum.IntEnum):
    LINEAR = 0
    QUADRATIC = 1
    CUBIC = 2
