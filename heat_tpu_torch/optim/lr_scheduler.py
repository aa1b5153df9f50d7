"""Learning-rate schedulers (port of ``heat_tpu.optim.lr_scheduler``).

The optimizers keep their learning rate as a float32 hyperparameter, as
``heat_tpu``'s optax state does, and a scheduler sets it through
``optimizer.set_lr`` after each ``scheduler.step()``; the rates are
``heat_tpu``'s, bit for bit.
"""

from __future__ import annotations

from .utils import DetectMetricPlateau

__all__ = ["StepLR", "ExponentialLR", "ReduceLROnPlateau"]


class _Scheduler:
    def __init__(self, optimizer):
        if not hasattr(optimizer, "set_lr") or not hasattr(optimizer, "lr"):
            raise TypeError("optimizer must expose lr/set_lr (DataParallelOptimizer)")
        self.optimizer = optimizer
        self.base_lr = optimizer.lr
        self.last_epoch = 0

    def get_last_lr(self):
        return [self.optimizer.lr]

    def step(self, *args) -> None:
        self.last_epoch += 1
        self._apply(*args)

    def _apply(self, *args) -> None:
        raise NotImplementedError


class StepLR(_Scheduler):
    """Decay lr by ``gamma`` every ``step_size`` steps (torch StepLR)."""

    def __init__(self, optimizer, step_size: int, gamma: float = 0.1):
        super().__init__(optimizer)
        self.step_size = int(step_size)
        self.gamma = float(gamma)

    def _apply(self) -> None:
        self.optimizer.set_lr(self.base_lr * self.gamma ** (self.last_epoch // self.step_size))


class ExponentialLR(_Scheduler):
    """Decay lr by ``gamma`` every step (torch ExponentialLR)."""

    def __init__(self, optimizer, gamma: float):
        super().__init__(optimizer)
        self.gamma = float(gamma)

    def _apply(self) -> None:
        self.optimizer.set_lr(self.base_lr * self.gamma ** self.last_epoch)


class ReduceLROnPlateau(_Scheduler):
    """Reduce lr when a metric plateaus (torch ReduceLROnPlateau; detector
    shared with DASO — reference optim/utils.py:14)."""

    def __init__(self, optimizer, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", min_lr: float = 0.0):
        super().__init__(optimizer)
        self.factor = float(factor)
        self.min_lr = float(min_lr)
        self.detector = DetectMetricPlateau(mode, patience, threshold, threshold_mode)

    def _apply(self, metric) -> None:
        if self.detector.test_if_improving(metric):
            self.optimizer.set_lr(max(self.optimizer.lr * self.factor, self.min_lr))
