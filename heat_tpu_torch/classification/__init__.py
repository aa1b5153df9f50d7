"""Classification (port of ``heat_tpu.classification``)."""

from .kneighborsclassifier import *
