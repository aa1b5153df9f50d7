"""Regression (port of ``heat_tpu.regression``)."""

from .lasso import *
