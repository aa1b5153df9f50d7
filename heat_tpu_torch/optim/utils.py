"""Optimizer utilities (port of ``heat_tpu.optim.utils``).

``DetectMetricPlateau`` (Heat reference utils.py:14), the plateau detector
that ``ReduceLROnPlateau`` and DASO's skip schedule consult, with its state
captured by ``get_state``/``set_state`` (reference utils.py:72, :89).
"""

from __future__ import annotations

from typing import Any, Dict

__all__ = ["DetectMetricPlateau"]


class DetectMetricPlateau:
    """Detects whether a tracked metric has stopped improving (reference
    utils.py:14; semantics follow torch's ReduceLROnPlateau detection).

    Parameters
    ----------
    mode : 'min' or 'max'
    patience : int
        Number of checks with no improvement before a plateau is declared.
    threshold : float
        Minimum relative change to count as an improvement.
    threshold_mode : 'rel' or 'abs'
    """

    def __init__(self, mode: str = "min", patience: int = 10,
                 threshold: float = 1e-4, threshold_mode: str = "rel"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode}")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"threshold_mode must be 'rel' or 'abs', got {threshold_mode}")
        self.mode = mode
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.threshold_mode = threshold_mode
        self.reset()

    def reset(self) -> None:
        self.best = float("inf") if self.mode == "min" else -float("inf")
        self.num_bad_epochs = 0

    def is_better(self, a: float, best: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < best * (1.0 - self.threshold)
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1.0 + self.threshold)
        return a > best + self.threshold

    def test_if_improving(self, metric) -> bool:
        """Record ``metric``; return True when a plateau is detected
        (reference utils.py:103: resets the counter on detection)."""
        current = float(metric)
        if self.is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            return True
        return False

    def get_state(self) -> Dict[str, Any]:
        """Capture detector state (reference utils.py:72)."""
        return {
            "mode": self.mode,
            "patience": self.patience,
            "threshold": self.threshold,
            "threshold_mode": self.threshold_mode,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        """Restore detector state (reference utils.py:89)."""
        for k, v in state.items():
            setattr(self, k, v)
