"""heat_tpu_torch — the PyTorch/CUDA port of heat_tpu.

It keeps heat_tpu's layout and public names, so that
``import heat_tpu_torch as ht`` reads like ``import heat_tpu as ht``::

    import heat_tpu_torch as ht
    A = ht.random.randn(65536, 8192, split=0)
    U, err = ht.linalg.hsvd_rank(A, 10)
    X = ht.random.randn(15_625_000, 64, split=0)
    km = ht.cluster.KMeans(n_clusters=8, init="kmeans++").fit(X)
    values, indices = ht.sort(ht.random.randn(134_217_728, split=0))
    S = ht.sparse.sparse_dbcsr_matrix(scipy_matrix, split=0)
    y = S @ x
    ranks = ht.graph.pagerank(adjacency).ranks
    q = ht.random.randn(1, 8, 16384, 128, dtype=ht.bfloat16, split=2)
    out = ht.nn.ring_attention(q, q, q, causal=True)
    mha = ht.nn.MultiheadAttention(1024, 8, causal=True)  # weights from ht.random's stream
    total = ht.arange(2**27, split=0).sum()
    B = ht.reshape(ht.random.randn(1000, 250000, split=1), (10_000_000, 25), new_split=1)
    Z = ht.preprocessing.StandardScaler().fit_transform(X)
    labels = ht.cluster.Spectral(n_clusters=8, gamma=0.05).fit(X[:32768]).labels_
    proba = ht.naive_bayes.GaussianNB().fit(X, km.labels_).predict_proba(X)
    x = ht.load_csv(ht.datasets.path("iris.csv"), sep=";", split=0)
    ht.utils.save_checkpoint("ckpt", {"x": x}); state = ht.utils.load_checkpoint("ckpt")

Arrays live on the GPU unless the caller asks for the CPU
(``ht.use_device("cpu")`` or ``device="cpu"``); without CUDA, creation on
the GPU raises. Hand-written CUDA kernels for Hopper (``csrc/``) carry the
streaming reads of the hSVD, the assignment pass of KMeans, the radix
sort under ``ht.sort``, ``ht.unique`` and ``ht.topk``, and the brick SpMM
and SDDMM of the sparse engine under ``ht.sparse`` and ``ht.graph``, and the
flash-attention forward K9 under ``ht.nn.ring_attention``,
``ht.nn.functional.scaled_dot_product_attention`` and
``ht.nn.MultiheadAttention``, and the pack and unpack copies K5 and K6 of
the redistribution executor under ``resplit`` and
``ht.reshape(..., new_split=)``; they are compiled at first use. The
estimators (``ht.preprocessing``, ``ht.naive_bayes``, ``ht.regression``,
``ht.classification``, ``ht.cluster.Spectral``, ``ht.graph``'s
``Laplacian`` and ``spectral_embedding``) reach them through these paths.

A process joins a multi-rank world with ``ht.init_distributed()`` (NCCL on
cards, one card per rank; gloo on the CPU), for example under
``torchrun --nproc-per-node=N``; a split array then holds on each rank
only its shard.
"""

from .core import *
from .core.linalg import *

from . import core
from . import classification
from . import cluster
from . import datasets
from . import graph
from . import kernels
from . import naive_bayes
from . import nn
from . import optim
from . import preprocessing
from . import redistribution
from . import regression
from . import sparse
from . import spatial
from . import utils
from . import version
from .version import __version__
