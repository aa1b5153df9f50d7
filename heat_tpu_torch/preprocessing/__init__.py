"""Data preprocessing (port of ``heat_tpu.preprocessing``): the five
scalers, and ``OneHotEncoder`` and ``TfidfTransformer``, whose outputs are
sparse."""

from .preprocessing import *
from .sparse_encoders import *
