"""Bundled example datasets (port of ``heat_tpu.datasets``; Heat reference:
heat/datasets): Fisher's iris (``iris.csv``, ``iris_labels.csv``,
``iris.h5``) and the diabetes study (``diabetes.h5``), for tests and
examples. The port carries its own copies of the files.

Use with the I/O layer::

    import heat_tpu_torch as ht
    from heat_tpu_torch import datasets

    x = ht.load_csv(datasets.path("iris.csv"), sep=";", split=0)
"""

import os

_DIR = os.path.dirname(os.path.abspath(__file__))

__all__ = ["path"]


def path(name: str) -> str:
    """Absolute path of a bundled dataset file (iris.h5, iris.csv,
    iris_labels.csv, diabetes.h5)."""
    p = os.path.join(_DIR, name)
    if not os.path.exists(p):
        raise FileNotFoundError(f"no bundled dataset {name!r} in {_DIR}")
    return p
