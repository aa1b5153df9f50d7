"""Mathematical constants (a copy of ``heat_tpu.core.constants``; Heat
reference: heat/core/constants.py)."""

import numpy as np

__all__ = ["e", "Euler", "inf", "Inf", "Infty", "Infinity", "nan", "NaN", "pi"]

e = float(np.e)
Euler = e
inf = float(np.inf)
Inf = inf
Infty = inf
Infinity = inf
nan = float(np.nan)
NaN = nan
pi = float(np.pi)
