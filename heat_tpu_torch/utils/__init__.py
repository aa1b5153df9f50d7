"""Utilities (port of ``heat_tpu.utils``)."""

from . import data
