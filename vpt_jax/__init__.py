"""vpt_jax — a differentiable volumetric rendering framework in JAX.

A from-scratch JAX re-design of the VPT volumetric path tracing
framework (reference: MOj0/vpt, WebGL2 + GLSL): the full renderer family (MIP,
ISO, EAM, DOS, LAO, MCS, MCM), 2D Gaussian-bump transfer functions,
environment lighting, the ten-curve tone-mapping suite, BVP/RAW volume I/O,
progressive accumulation, and multi-device ray/volume sharding — all
differentiable w.r.t. voxel densities and transfer-function parameters.
"""

__version__ = "0.1.0"

from . import colorspaces, environment, math3d, rng, sampling, scene  # noqa: F401
from . import tonemap, transfer, volume  # noqa: F401
from .scene import CameraState, Node, PerspectiveCamera, Transform, default_camera  # noqa: F401
from .transfer import TransferFunctionBumps, rasterize  # noqa: F401
from .volume import Volume  # noqa: F401
