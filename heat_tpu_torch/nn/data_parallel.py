"""Data-parallel model wrapper (port of ``heat_tpu.nn.data_parallel``).

``heat_tpu`` keeps the parameters replicated over its mesh and lets GSPMD
all-reduce the gradient inside one jitted step. The port runs a process
per rank: every rank holds the whole parameters (drawn from the same key,
so no broadcast is needed), and the optimizers of ``heat_tpu_torch.optim``
all-reduce the gradients. ``DataParallelMultiGPU`` is the same wrapper, for
``DASO``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import _threefry, types
from ..core.communication import sanitize_comm
from ..core.dndarray import DNDarray
from .modules import Module

__all__ = ["DataParallel", "DataParallelMultiGPU"]


def _key_of(key):
    """An int seeds ``jax.random.PRNGKey(key)``'s key; a key passes."""
    return _threefry.seed_key(int(key)) if isinstance(key, int) else key


def batch_of(x: DNDarray):
    """``(start, total)`` of this rank's rows in ``x``'s global batch: the
    ``batch`` argument of the modules' forward."""
    if x.is_distributed() and x.split == 0:
        counts, displs = x.counts_displs()
        return displs[x.comm.rank], x.shape[0]
    return 0, x.shape[0]


class DataParallel:
    """A module with its parameters, replicated over the ranks of ``comm``
    (``heat_tpu``'s ``DataParallel(module, comm=None, key=0)``):
    ``module.init(key)`` draws them, the same on every rank.

    ``model(x, train=False, key=None)`` runs the module on a DNDarray batch
    (each rank its rows, the result split like ``x``; dropout draws the
    rank's rows of one global mask) or on a tensor. An optimizer that
    keeps other weights than the module's (``DASO``) installs
    ``_param_override``, and forwards, ``parameters()`` and
    ``state_dict()`` then see those."""

    def __init__(self, module: Module, comm=None, key=0):
        if not isinstance(module, Module):
            raise TypeError(f"module must be a heat_tpu_torch.nn.Module, got {type(module)}")
        self.module = module
        self.comm = sanitize_comm(comm)
        module.init(_key_of(key))
        self._param_override = None
        self._owner = None

    def _current_params(self) -> dict:
        if self._param_override is not None:
            return self._param_override()
        return dict(self.module.named_parameters())

    def _forward(self, x: torch.Tensor, train: bool, key, batch) -> torch.Tensor:
        was = self.module.training
        self.module.train(train)
        try:
            if self._param_override is None:
                return self.module(x, key=key, batch=batch)
            return torch.func.functional_call(self.module, self._param_override(), (x,), {"key": key, "batch": batch})
        finally:
            self.module.train(was)

    def __call__(self, x, *, train: bool = False, key=None):
        """Forward pass: DNDarray in, DNDarray out (the batch's split kept);
        a tensor passes through the module."""
        if not isinstance(x, DNDarray):
            return self._forward(x, train, key, None)
        out = self._forward(x.larray, train, key, batch_of(x))
        split = x.split if x.split is not None and x.split < out.ndim else None
        gshape = (x.shape[0],) + tuple(out.shape[1:]) if split == 0 else tuple(out.shape)
        lmap = None
        if split == 0 and x.is_distributed():
            lmap = x.comm.lshape_map(gshape, 0)
            lmap[:, 0] = x.lshape_map[:, 0]
        return DNDarray(out, gshape, types.canonical_heat_type(out.dtype), split, x.device, self.comm, lmap)

    forward = __call__

    def parameters(self):
        """The current parameters (under ``DASO``: the node average)."""
        return iter(self._current_params().values())

    def state_dict(self) -> dict:
        """The current weights by name (under ``DASO``: the node average)."""
        return {name: p.detach().clone() for name, p in self._current_params().items()}

    def load_state_dict(self, params: dict) -> None:
        """Load weights by name into the module; an owning optimizer
        (``DASO``) adopts them too."""
        own = dict(self.module.named_parameters())
        with torch.no_grad():
            for name, value in params.items():
                own[name].copy_(torch.as_tensor(value, device=own[name].device, dtype=own[name].dtype))
        if self._owner is not None:
            self._owner.load_params(params)

    def train(self):
        return self

    def eval(self):
        return self


class DataParallelMultiGPU(DataParallel):
    """``heat_tpu``'s ``DataParallelMultiGPU``: the same wrapper, which a
    ``DASO`` optimizer adopts."""

    def __init__(self, module: Module, comm=None, key=0):
        super().__init__(module, comm, key)
