"""scikit-learn-style estimator API.

Port of ``heat_tpu.core.base`` (Heat reference: heat/core/base.py,
``BaseEstimator`` :13, ``ClassificationMixin`` :96, ``TransformMixin``
:143, ``ClusteringMixin`` :184, ``RegressionMixin`` :215, ``is_*`` helpers
:260-309). Pure Python, as in both.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, TypeVar

from .dndarray import DNDarray

__all__ = [
    "BaseEstimator",
    "ClassificationMixin",
    "ClusteringMixin",
    "RegressionMixin",
    "TransformMixin",
    "is_classifier",
    "is_estimator",
    "is_clusterer",
    "is_regressor",
    "is_transformer",
]

self_t = TypeVar("self_t")


class BaseEstimator:
    """Abstract base for all estimators: hyperparameter get/set and repr
    (reference: base.py:13)."""

    @classmethod
    def _parameter_names(cls) -> List[str]:
        init = cls.__init__
        if init is object.__init__:
            return []
        sig = inspect.signature(init)
        return sorted(
            p.name
            for p in sig.parameters.values()
            if p.name != "self" and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
        )

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        """Hyperparameters of this estimator (reference: base.py get_params)."""
        params = {}
        for key in self._parameter_names():
            value = getattr(self, key, None)
            if deep and hasattr(value, "get_params"):
                for sub_key, sub_value in value.get_params().items():
                    params[f"{key}__{sub_key}"] = sub_value
            params[key] = value
        return params

    def set_params(self: self_t, **params: Dict[str, Any]) -> self_t:
        """Set hyperparameters (reference: base.py set_params)."""
        if not params:
            return self
        own = self.get_params(deep=True)
        for key, value in params.items():
            key, delim, sub_key = key.partition("__")
            if key not in own:
                raise ValueError(f"invalid parameter {key} for estimator {self}")
            if delim:
                getattr(self, key).set_params(**{sub_key: value})
            else:
                setattr(self, key, value)
        return self

    def __repr__(self, indent: int = 1) -> str:
        params = ", ".join(f"{k}={v!r}" for k, v in sorted(self.get_params(deep=False).items()))
        return f"{self.__class__.__name__}({params})"


class ClassificationMixin:
    """Mixin for all classifiers (reference: base.py:96)."""

    def fit(self, x: DNDarray, y: DNDarray):
        raise NotImplementedError()

    def fit_predict(self, x: DNDarray, y: DNDarray) -> DNDarray:
        """Fit then predict on the same data."""
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x: DNDarray) -> DNDarray:
        raise NotImplementedError()


class TransformMixin:
    """Mixin for all transformations (reference: base.py:143)."""

    def fit(self, x: DNDarray):
        raise NotImplementedError()

    def fit_transform(self, x: DNDarray) -> DNDarray:
        """Fit then transform the same data."""
        return self.fit(x).transform(x)

    def transform(self, x: DNDarray) -> DNDarray:
        raise NotImplementedError()


class ClusteringMixin:
    """Mixin for all clustering algorithms (reference: base.py:184)."""

    def fit(self, x: DNDarray):
        raise NotImplementedError()

    def fit_predict(self, x: DNDarray) -> DNDarray:
        """Fit then return cluster labels."""
        self.fit(x)
        return self.predict(x)


class RegressionMixin:
    """Mixin for all regression estimators (reference: base.py:215)."""

    def fit(self, x: DNDarray, y: DNDarray):
        raise NotImplementedError()

    def fit_predict(self, x: DNDarray, y: DNDarray) -> DNDarray:
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x: DNDarray) -> DNDarray:
        raise NotImplementedError()


def is_classifier(estimator: object) -> bool:
    """True if ``estimator`` is a classifier (reference: base.py:260)."""
    return isinstance(estimator, ClassificationMixin)


def is_estimator(estimator: object) -> bool:
    """True if ``estimator`` is an estimator."""
    return isinstance(estimator, BaseEstimator)


def is_clusterer(estimator: object) -> bool:
    """True if ``estimator`` is a clusterer."""
    return isinstance(estimator, ClusteringMixin)


def is_regressor(estimator: object) -> bool:
    """True if ``estimator`` is a regressor."""
    return isinstance(estimator, RegressionMixin)


def is_transformer(estimator: object) -> bool:
    """True if ``estimator`` is a transformer."""
    return isinstance(estimator, TransformMixin)
