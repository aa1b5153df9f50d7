"""Naive Bayes (port of ``heat_tpu.naive_bayes``)."""

from .gaussianNB import *
