"""Spatial algorithms (port of ``heat_tpu.spatial``)."""

from .distance import *
