"""PyTorch + CUDA port of climt_tpu.

The package mirrors ``climt_tpu``'s layout (``core/``, ``ops/``,
``dycore/``, ``components/``) module for module, so that every ported
function has one JAX counterpart to be tested against.  It imports
``torch`` and never ``jax`` or ``climt_tpu``; constants and numpy-only
helpers it needs from the JAX package are copied with their source line
named beside them, and the RRTMG tables are read by path (``data.py``).

The two radiation kernels that the JAX package writes in Pallas are
hand-written CUDA here (``csrc/``), built with ``nvcc`` for ``sm_90a`` at
first use (``_build.py``); the NetCDF writer's C extension
(``io/_fastio.c``) is built with the system C compiler at its first use.
Importing the package compiles nothing.

Entry points: climt's component API under the names ``climt_tpu``
exports (``import climt_tpu_torch as ct``; ``ct.get_grid``,
``ct.get_default_state``, ``ct.GFSDynamicalCore``, every physics
component of ``climt_tpu.components`` -- radiation, convection,
condensation, boundary layer, surface, land, ice, insolation and the
DCMIP initial states -- the steppers and wrappers, the three monitors),
and the fused models
``climt_tpu_torch.dycore.moist_gcm.build_moist_gcm`` and
``climt_tpu_torch.dycore.compiled.build_held_suarez_model``.  Moisture
and registered tracers move in spectral or grid space (``ops/``'s FV and
semi-Lagrangian operators).  CORK longwave radiation (correlated-k
tables and Parmentier picket-fence optics) is
``climt_tpu_torch.components.cork.lw.CorkLongwaveRadiation``, not
exported here, as the JAX package does not export it.  The repository's
two entry points, the flagship step ``entry()`` and the m-sharded check
``dryrun_multichip(n)`` of ``__graft_entry__.py``, are
``climt_tpu_torch.entry_points``.  Whatever builds on a device takes
``device=`` and defaults to the CUDA card.
"""

from .core.base_components import (
    ComponentBase, ConstantDiagnosticComponent, ConstantTendencyComponent,
    DiagnosticComponent, ImplicitTendencyComponent, Stepper,
    TendencyComponent,
)
from .core.constants import (
    ConstantNotFoundError, constant_names, get_constant,
    get_constants_string, list_available_constants, reset_constants,
    set_constant, set_constants_from_dict,
)
from .core.dataarray import DataArray
from .core.grid import (
    HybridSigmaPressureDiagnosticComponent, gaussian_latitudes, get_grid,
    hybrid_sigma_pressure_coefficients,
)
from .core.initialization import (
    ConstantDefaultValue, PressureFunctionDiagnosticComponent,
    aggregate_input_properties, default_values, get_default_state,
    get_init_diagnostic, init_ozone,
)
from .core.properties import (
    InvalidPropertyDictError, InvalidStateError,
    combine_component_properties, extract_arrays, restore_arrays,
)
from .core.steppers import (
    AdamsBashforth, Leapfrog, SSPRungeKutta, TendencyStepper,
)
from .core.units import (
    UnitError, conversion_factor, is_valid_unit, units_are_compatible,
    units_are_same,
)
from .core.util import (
    bolton_dqsat_dT, bolton_q_sat, calculate_q_sat, get_interface_values,
    mass_to_volume_mixing_ratio, numpy_version_of, torch_version_of,
)
from .core.wrappers import (
    ScalingWrapper, TimeDifferencingWrapper, UpdateFrequencyWrapper,
)
from .core.tracers import (
    TracerPacker, get_tracer_names, get_tracer_unit_dict, register_tracer,
    reset_packers, reset_tracers,
)
from .io.monitors import (
    NetCDFMonitor, PlotFunctionMonitor, RestartMonitor,
)
from .components import (
    BergerSolarInsolation, BestSoilProperties, BestSubsurfaceTransport,
    BestSurfaceAlbedo, BestSurfaceFluxes, BestSurfaceLayer, BucketHydrology,
    DataOcean, DcmipInitialConditions, DryConvectiveAdjustment,
    EmanuelConvection, EmanuelConvectionPython,
    Frierson06LongwaveOpticalDepth, GrayLongwaveRadiation,
    GridScaleCondensation, HeldSuarez, IceSheet, Instellation, LandIce,
    LandMask, RRTMGLongwave, RRTMGShortwave, SeaIce, SecondBEST,
    SimpleBoundaryLayer, SimplePhysics, SlabSurface,
)
from .dycore.gfs import GFSDynamicalCore
from .dycore.spectral_dynamics import SpectralDycore
from . import entry_points

__version__ = '0.1.0'

# climt overrides the model-top pressure at import; the JAX package does
# the same (climt_tpu/__init__.py:74), and so must this one, or the grids
# differ.
set_constant('top_of_model_pressure', 20., 'Pa')
