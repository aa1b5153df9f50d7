"""Utilities (port of ``heat_tpu.utils``): the data tools, the vision
transforms and checkpoints of training state."""

from . import checkpoint
from . import data
from . import vision_transforms
from .checkpoint import load_checkpoint, save_checkpoint
