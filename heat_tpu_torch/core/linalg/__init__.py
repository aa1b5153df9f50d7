"""Linear algebra of heat_tpu_torch (port of ``heat_tpu.core.linalg``)."""

from .basics import *
from .qr import *
from .solver import *
from .svd import *
from .svdtools import *
from .factorizations import *
