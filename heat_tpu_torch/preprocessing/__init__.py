"""Data preprocessing (port of ``heat_tpu.preprocessing``): the five
scalers. ``heat_tpu``'s ``sparse_encoders`` (``OneHotEncoder``,
``TfidfTransformer``) are not ported yet (ROADMAP.md Queue 1, item 10 (b))."""

from .preprocessing import *
