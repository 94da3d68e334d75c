"""Physics components of the port: the 27 classes that
``climt_tpu.components`` exports, under the same names."""

from .berger_solar_insolation import BergerSolarInsolation
from .boundary_layer import SimpleBoundaryLayer
from .bucket_hydrology import BucketHydrology
from .condensation import GridScaleCondensation
from .dcmip import DcmipInitialConditions
from .dry_convection import DryConvectiveAdjustment
from .emanuel_convection import EmanuelConvection, EmanuelConvectionPython
from .geodata import DataOcean, LandMask
from .held_suarez import HeldSuarez
from .instellation import Instellation
from .radiation import Frierson06LongwaveOpticalDepth, GrayLongwaveRadiation
from .rrtmg.longwave import RRTMGLongwave
from .rrtmg.shortwave import RRTMGShortwave
from .second_best import (
    BestSoilProperties, BestSubsurfaceTransport, BestSurfaceAlbedo,
    BestSurfaceFluxes, BestSurfaceLayer, SecondBEST,
)
from .simple_physics import SimplePhysics
from .slab_surface import SlabSurface
from .snow_ice import IceSheet, LandIce, SeaIce
