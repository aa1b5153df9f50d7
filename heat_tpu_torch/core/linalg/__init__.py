"""Linear algebra of heat_tpu_torch (port of ``heat_tpu.core.linalg``)."""

from .svdtools import *
