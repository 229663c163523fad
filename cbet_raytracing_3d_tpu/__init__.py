"""cbet_raytracing_3d_tpu — a JAX (XLA/shard_map) framework for 3-D laser
ray tracing, inverse-bremsstrahlung absorption, energy
deposition, and cross-beam energy transfer (CBET) in spherically symmetric
ICF plasmas.

Capability-parity rebuild of the CUDA reference ``abowman6/CBET_RayTracing_3D``
(see SURVEY.md for the structural map); scene-compatible inputs (OMEGA 60-beam
geometry, s83177 ne/te profiles) and ``truth``-comparable outputs.
"""

from .config import Config, small_test_config
from .profiles import load_profiles, RadialProfiles
from .beams import load_beam_norms, power_table, init_rays
from .fields import build_fields, Fields

__version__ = "0.1.0"

__all__ = [
    "Config", "small_test_config", "load_profiles", "RadialProfiles",
    "load_beam_norms", "power_table", "init_rays", "build_fields", "Fields",
    "__version__",
]
