"""heat_tpu_torch core: array, type system, devices, communicator,
factories, indexing, manipulations, elementwise operations, reductions,
statistics, memory, printing, the 1-D convolution, the tile maps and the
CSV/HDF5 I/O (port of ``heat_tpu.core``)."""

from .base import *
from .communication import *
from .constants import *
from .devices import *
from .types import *
from .dndarray import *
from .factories import *
from .indexing import *
from .memory import *
from .printing import *
from .manipulations import *
from .arithmetics import *
from .complex_math import *
from .exponential import *
from .logical import *
from .relational import *
from .rounding import *
from .statistics import *
from .trigonometrics import *
from .sanitation import *
from .signal import *
from .stride_tricks import *
from .tiling import *
from .io import *

from . import interop
from . import io
from . import parallel
from . import signal
from . import tiling
from . import random

from . import linalg
from .linalg import *
