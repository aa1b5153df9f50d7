"""Linear algebra of heat_tpu_torch (port of ``heat_tpu.core.linalg``)."""

from .basics import *
from .qr import *
from .svdtools import *
