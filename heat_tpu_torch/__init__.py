"""heat_tpu_torch — the PyTorch/CUDA port of heat_tpu.

It keeps heat_tpu's layout and public names, so that
``import heat_tpu_torch as ht`` reads like ``import heat_tpu as ht``::

    import heat_tpu_torch as ht
    A = ht.random.randn(65536, 8192, split=0)
    U, err = ht.linalg.hsvd_rank(A, 10)
    X = ht.random.randn(15_625_000, 64, split=0)
    km = ht.cluster.KMeans(n_clusters=8, init="kmeans++").fit(X)
    values, indices = ht.sort(ht.random.randn(134_217_728, split=0))

Arrays live on the GPU unless the caller asks for the CPU
(``ht.use_device("cpu")`` or ``device="cpu"``); without CUDA, creation on
the GPU raises. Hand-written CUDA kernels for Hopper (``csrc/``) carry the
streaming reads of the hSVD, the assignment pass of KMeans and the radix
sort under ``ht.sort``, ``ht.unique`` and ``ht.topk``; they are compiled
at first use.
"""

from .core import *
from .core.linalg import *

from . import core
from . import cluster
from . import kernels
from . import spatial
from . import utils
