"""Data-parallel optimizers (port of ``heat_tpu.optim.dp_optimizer``).

``heat_tpu`` runs one jitted step on its mesh: forward, ``value_and_grad``
of the global-mean loss (GSPMD all-reduces the gradient) and an optax
update. The port runs a process per rank in torch's idiom: each rank
takes ``loss.backward()`` of its own rows' loss sum, one all-reduce sums
the flattened gradients with the row count and the loss, each rank
divides by the global count and applies the same update to its copy of
the parameters, so every rank keeps the same weights.

The local optimizers write optax's updates out on tensors, in its order
of operations and in float32 hyperparameters (``inject_hyperparams``):
``SGD`` (``add_decayed_weights``, then ``trace`` with momentum and
nesterov), ``Adam`` (the decay first, then ``scale_by_adam``) and
``AdamW`` (``scale_by_adam``, then the decay), each scaled by −lr.

``DASO`` keeps ``heat_tpu``'s two-level schedule: nodes are groups of
consecutive ranks; every step all-reduces the gradients within a node,
and every ``global_skip``-th step averages the parameters over the ranks
with the same place in their nodes (a bfloat16 wire with
``compression``). The groups are the communicator's ``subgroups``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import _threefry
from ..core.dndarray import DNDarray
from ..nn.modules import CrossEntropyLoss, aligned_rows, scalar_dndarray
from ..nn.data_parallel import batch_of

__all__ = ["SGD", "Adam", "AdamW", "LocalOptimizer", "DataParallelOptimizer", "DASO"]


def _f32(v) -> float:
    """``v`` rounded to float32, as an injected optax hyperparameter holds it."""
    return float(np.float32(v))


class LocalOptimizer:
    """A per-replica update rule, the role of a torch optimizer in the Heat
    reference (dp_optimizer.py:868). ``hyperparams()`` gives the float32
    hyperparameters a wrapper keeps (``learning_rate``, ``weight_decay``),
    ``init(params)`` the state tensors, ``update(params, grads, state,
    hyper)`` advances the parameters in place."""

    def __init__(self, defaults: dict):
        self.defaults = dict(defaults)

    def hyperparams(self) -> Dict[str, float]:
        return {"learning_rate": _f32(self.defaults["lr"]), "weight_decay": _f32(self.defaults["weight_decay"])}

    def init(self, params: List[torch.Tensor]) -> Dict[str, list]:
        return {}

    def update(self, params, grads, state: dict, hyper: dict) -> None:
        raise NotImplementedError

    @staticmethod
    def _apply(p: torch.Tensor, u: torch.Tensor, lr: float) -> None:
        """``optax.apply_updates`` of ``scale(-lr)``: the update times −lr,
        rounded, then added."""
        p.add_(u * (-lr))


class SGD(LocalOptimizer):
    """``optax.sgd`` with momentum and nesterov, after
    ``add_decayed_weights`` when ``weight_decay`` (``heat_tpu`` :71)."""

    def __init__(self, lr: float = 0.01, momentum: float = 0.0, weight_decay: float = 0.0, nesterov: bool = False):
        super().__init__(dict(lr=lr, momentum=momentum, weight_decay=weight_decay))
        self.nesterov = bool(nesterov)

    def init(self, params):
        return {"trace": [torch.zeros_like(p) for p in params]} if self.defaults["momentum"] else {}

    @torch.no_grad()
    def update(self, params, grads, state, hyper):
        m, wd = self.defaults["momentum"], hyper["weight_decay"]
        for i, (p, g) in enumerate(zip(params, grads)):
            if wd:  # heat_tpu chains add_decayed_weights only for a nonzero decay
                g = g + wd * p
            if m:
                t = state["trace"][i]
                t.mul_(m).add_(g)
                g = g + m * t if self.nesterov else t
            self._apply(p, g, hyper["learning_rate"])


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay**count``, computed in float64 and held as the
    moment's float32."""
    return _f32(1.0 - decay**count)


class Adam(LocalOptimizer):
    """``optax.adam`` after ``add_decayed_weights`` when ``weight_decay``
    (``heat_tpu`` :94)."""

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    def init(self, params):
        return {"mu": [torch.zeros_like(p) for p in params], "nu": [torch.zeros_like(p) for p in params],
                "count": [torch.zeros((), dtype=torch.int32)]}

    def _adam(self, g, i, state, count):
        """``scale_by_adam``'s update of one parameter's moments."""
        b1, b2 = self.defaults["betas"]
        mu, nu = state["mu"][i], state["nu"][i]
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * (g * g))
        mu_hat = mu / _bias_correction(b1, count)
        nu_hat = nu / _bias_correction(b2, count)
        return mu_hat / (torch.sqrt(nu_hat) + self.defaults["eps"])

    @torch.no_grad()
    def update(self, params, grads, state, hyper):
        state["count"][0] += 1
        count = int(state["count"][0])
        wd = hyper["weight_decay"]
        for i, (p, g) in enumerate(zip(params, grads)):
            if wd:
                g = g + wd * p
            self._apply(p, self._adam(g, i, state, count), hyper["learning_rate"])


class AdamW(Adam):
    """``optax.adamw``: ``scale_by_adam``, then the decoupled decay
    (``heat_tpu`` :115)."""

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-2):
        super().__init__(lr, betas, eps, weight_decay)

    @torch.no_grad()
    def update(self, params, grads, state, hyper):
        state["count"][0] += 1
        count = int(state["count"][0])
        for i, (p, g) in enumerate(zip(params, grads)):
            u = self._adam(g, i, state, count) + hyper["weight_decay"] * p
            self._apply(p, u, hyper["learning_rate"])


def _refuse_wire_quant(wire_quant) -> None:
    if wire_quant is not None:
        raise NotImplementedError(
            "DataParallelOptimizer(wire_quant=...): the quantized gradient wire and its error-feedback carry need "
            "kernels/quant.py, which is not ported (ROADMAP.md Queue 1, item 12)"
        )


def _local_sums(model, loss, xb: torch.Tensor, yb, key, batch):
    """The gradient of this rank's rows' loss sum: ``loss.raw`` (the
    weighted mean) times the rows' weight, through ``backward``. Returns
    the parameters, their gradients (zeros where none reached them, as on
    a rank without rows) and the loss sum and row count as one float
    tensor of two values."""
    module = model.module
    params = list(module.parameters())
    for p in params:
        p.grad = None
    module.train(True)
    out = module(xb, key=key, batch=batch)
    w = torch.ones(xb.shape[0], dtype=xb.dtype if xb.is_floating_point() else out.dtype, device=out.device)
    total = loss.raw(out, yb, weight=w) * torch.sum(w)
    total.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    for p in params:
        p.grad = None
    return params, grads, torch.stack([total.detach(), torch.sum(w)])


def _flat(tensors: List[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(dtype) for t in tensors])


def _unflat(flat: torch.Tensor, like: List[torch.Tensor]) -> List[torch.Tensor]:
    parts = flat.split([t.numel() for t in like])
    return [part.reshape(t.shape).to(t.dtype) for part, t in zip(parts, like)]


def _operands(x: DNDarray, y):
    """This rank's rows of the batch and the labels aligned with them; a
    batch split along another axis moves to axis 0 first."""
    if x.is_distributed() and x.split != 0:
        x = x.resplit(0)
    return x, x.larray, aligned_rows(y, x).to(x.larray.device)


class _ReducedStep:
    """What both data-parallel optimizers share: the local optimizer and its
    state, the learning rate, and a step's gradient of the rank's rows, its
    all-reduce and the local update."""

    def __init__(self, local_optimizer, model, loss):
        if not isinstance(local_optimizer, LocalOptimizer):
            raise TypeError(f"local_optimizer must be a heat_tpu_torch.optim optimizer, got {type(local_optimizer)}")
        self.model = model
        self.local = local_optimizer
        self.loss = loss if loss is not None else CrossEntropyLoss()
        self.hyper = local_optimizer.hyperparams()
        self.opt_state = local_optimizer.init(list(model.module.parameters()))
        self._iter = 0
        self._base_key = _threefry.seed_key(0)

    def zero_grad(self) -> None:
        """Nothing to do: the step clears the gradients it takes."""

    @property
    def lr(self) -> float:
        return self.hyper["learning_rate"]

    def set_lr(self, lr: float) -> None:
        self.hyper["learning_rate"] = _f32(lr)

    def _reduced_update(self, xb: torch.Tensor, yb, key, batch, reduce: bool, group=None) -> torch.Tensor:
        """The gradient of this rank's rows' loss sum, all-reduced with the
        loss sum and the row count (over ``group`` when ``reduce``), divided
        by the count and applied; returns the reduced (loss sum, count)."""
        params, grads, tail = _local_sums(self.model, self.loss, xb, yb, key, batch)
        dtype = torch.promote_types(params[0].dtype, torch.float32) if params else torch.float32
        flat = torch.cat([_flat(grads, dtype), tail.to(dtype)])
        if reduce:
            flat = self.model.comm.allreduce(flat, group=group)
        n = torch.clamp_min(flat[-1], 1.0)
        self.local.update(params, _unflat(flat[:-2] / n, params), self.opt_state, self.hyper)
        return flat[-2:]


class DataParallelOptimizer(_ReducedStep):
    """Synchronous data-parallel optimizer (``heat_tpu`` :146; Heat
    reference dp_optimizer.py:851).

    ``step(x, y)`` trains on the global batch ``x`` (split 0: each rank its
    rows) with labels ``y``: the dropout key is ``fold_in(key(0), step)``
    and each rank draws its rows of the one global mask; one all-reduce
    sums the gradients, the row count and the loss; the result is the
    global mean loss as a replicated 0-d DNDarray. A rank without rows
    takes the collective with zeros. ``wire_quant`` raises
    ``NotImplementedError`` (ROADMAP.md Queue 1, item 12)."""

    def __init__(self, local_optimizer, model, loss=None, blocking: bool = True, wire_quant: Optional[str] = None):
        super().__init__(local_optimizer, model, loss)
        _refuse_wire_quant(wire_quant)
        self.blocking = bool(blocking)
        self.wire_quant = None

    def step(self, x: DNDarray, y) -> DNDarray:
        """One training step on the global batch; returns the global mean
        loss."""
        x, xb, yb = _operands(x, y)
        self._iter += 1
        dropkey = _threefry.fold_in(self._base_key, self._iter)
        total = self._reduced_update(xb, yb, dropkey, batch_of(x), x.is_distributed())
        return scalar_dndarray(total[0] / torch.clamp_min(total[1], 1.0), self.model.comm, x.device)

    def checkpoint_state(self) -> dict:
        """What a resume needs, bit for bit: the parameters, the optimizer
        state and hyperparameters, the step counter the dropout key folds
        in and the base key."""
        params = [p.detach().clone() for p in self.model.module.parameters()]
        opt = [t.clone() for name in sorted(self.opt_state) for t in self.opt_state[name]]
        state = {f"param_{i:04d}": p for i, p in enumerate(params)}
        state.update({f"opt_{i:04d}": t for i, t in enumerate(opt)})
        state.update(base_key=np.asarray(self._base_key, dtype=np.uint32), iter=int(self._iter), n_params=len(params),
                     n_opt=len(opt), hyper=dict(self.hyper), wire_quant="")
        return state

    def load_checkpoint_state(self, state: dict) -> None:
        """Adopt ``checkpoint_state()``'s dict; a checkpoint of another
        architecture raises before anything changes."""
        params = list(self.model.module.parameters())
        opt = [t for name in sorted(self.opt_state) for t in self.opt_state[name]]
        n_p, n_o = int(state["n_params"]), int(state["n_opt"])
        if n_p != len(params) or n_o != len(opt):
            raise ValueError(
                f"checkpoint carries {n_p} param / {n_o} optimizer tensors but this optimizer has "
                f"{len(params)} / {len(opt)}: architectures differ"
            )
        _refuse_wire_quant(state.get("wire_quant") or None)
        with torch.no_grad():
            for i, p in enumerate(params):
                p.copy_(torch.as_tensor(state[f"param_{i:04d}"]).to(device=p.device, dtype=p.dtype))
            for i, t in enumerate(opt):
                t.copy_(torch.as_tensor(state[f"opt_{i:04d}"]).to(device=t.device, dtype=t.dtype))
        self.hyper = dict(state["hyper"])
        self._iter = int(state["iter"])
        self._base_key = tuple(int(v) for v in np.asarray(state["base_key"]).reshape(-1))


class DASO(_ReducedStep):
    """Distributed Asynchronous and Selective Optimization (``heat_tpu``
    :438; Heat reference dp_optimizer.py:64): ``n_nodes`` groups of
    consecutive ranks (default 2 on an even world). Every step all-reduces
    the gradients within the rank's node and divides by the node's rows;
    every ``global_skip``-th step then averages the parameters over the
    ranks with the same local index (``compression``: a bfloat16 wire,
    summed, then divided by ``n_nodes``). Rank r's dropout key is
    ``fold_in(fold_in(key(0), step), r)``, its mask its own rows'.
    Forwards of the wrapped model see the node average
    (``_eval_params``); ``epoch_loss_logic`` is the reference's schedule.
    """

    def __init__(self, local_optimizer, model, n_nodes: Optional[int] = None, global_skip: int = 4,
                 compression: bool = True, loss=None, total_epochs: Optional[int] = None, warmup_epochs: int = 4,
                 cooldown_epochs: int = 4, stability_level: float = 0.05, max_global_skips: int = 8,
                 skip_reduction_factor: int = 2, local_skip_factor: int = 4):
        from .utils import DetectMetricPlateau

        super().__init__(local_optimizer, model, loss)
        self.comm = model.comm
        size = self.comm.size
        if n_nodes is None:
            n_nodes = 2 if size % 2 == 0 and size > 1 else 1
        if size % n_nodes != 0:
            raise ValueError(f"world size {size} not divisible by n_nodes {n_nodes}")
        self.n_nodes = int(n_nodes)
        self.local_size = size // self.n_nodes
        self.global_skip = int(global_skip)
        self.compression = bool(compression)
        self._within, self._across = self.comm.subgroups(self.n_nodes, self.local_size) if size > 1 else (None, None)
        self.total_epochs = total_epochs
        self.warmup_epochs = int(warmup_epochs)
        self.cooldown_epochs = int(cooldown_epochs)
        self.max_gs = int(max_global_skips)
        self.skip_reduction_factor = int(skip_reduction_factor)
        self.local_skip_factor = int(local_skip_factor)
        self.stability = DetectMetricPlateau(patience=2, threshold=float(stability_level))
        self.epoch = 0
        # kept for the schedule's parity: a node all-reduces every batch
        self.local_skip = 1
        self.batches_to_wait = 1
        self._eval_cache = (-1, None)
        model._param_override = self._eval_params
        model._owner = self

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """This rank's node's parameters."""
        return dict(self.model.module.named_parameters())

    def _node_mean(self, tensors: List[torch.Tensor], wire: Optional[torch.dtype] = None) -> List[torch.Tensor]:
        """The mean over the nodes of each tensor (held by every rank of a
        node): one all-reduce over the ranks with this rank's local index,
        on ``wire`` when given (summed there, divided by ``n_nodes`` there,
        then cast back)."""
        if self.n_nodes == 1:
            return [t.detach().clone() for t in tensors]
        dtype = wire if wire is not None else tensors[0].dtype
        flat = self.comm.allreduce(_flat(tensors, dtype), group=self._across)
        return _unflat(flat / self.n_nodes, tensors)

    def _eval_params(self) -> Dict[str, torch.Tensor]:
        it, cached = self._eval_cache
        if it != self._iter:
            names, params = zip(*self.model.module.named_parameters())
            cached = dict(zip(names, self._node_mean(list(params))))
            self._eval_cache = (self._iter, cached)
        return cached

    def step(self, x: DNDarray, y) -> DNDarray:
        """One DASO step: the node's gradient all-reduce, and every
        ``global_skip`` steps the parameters averaged over the nodes."""
        x, xb, yb = _operands(x, y)
        self._iter += 1
        global_sync = self.global_skip <= 1 or self._iter % self.global_skip == 0
        dropkey = _threefry.fold_in(_threefry.fold_in(self._base_key, self._iter), self.comm.rank)
        total = self._reduced_update(xb, yb, dropkey, None, self.comm.is_distributed(), self._within)
        if global_sync and self.n_nodes > 1:
            params = list(self.model.module.parameters())
            wire = torch.bfloat16 if self.compression else None
            with torch.no_grad():
                for p, mean in zip(params, self._node_mean(params, wire)):
                    p.copy_(mean)
        if self.n_nodes > 1:
            total = self.comm.allreduce(total, group=self._across)
        return scalar_dndarray(total[0] / torch.clamp_min(total[1], 1.0), self.comm, x.device)

    def load_params(self, params: dict) -> None:
        """Adopt loaded weights (by name) on every node and start the
        optimizer state afresh (the reference's checkpoints carry no
        momentum, optim/utils.py:72)."""
        own = dict(self.model.module.named_parameters())
        with torch.no_grad():
            for name, value in params.items():
                own[name].copy_(torch.as_tensor(value).to(device=own[name].device, dtype=own[name].dtype))
        self.opt_state = self.local.init(list(own.values()))
        self._eval_cache = (-1, None)

    def sync_params(self) -> None:
        """Average the parameters over the nodes now and give every rank
        the average (the reference's end-of-epoch sync, :700-780)."""
        params = list(self.model.module.parameters())
        with torch.no_grad():
            for p, mean in zip(params, self._node_mean(params)):
                p.copy_(mean)
        self._eval_cache = (-1, None)

    def epoch_loss_logic(self, loss, loss_globally_averaged: bool = True) -> None:
        """Adapt the sync schedule from the end-of-epoch loss, the
        reference's policy (dp_optimizer.py:354-470, ``heat_tpu`` :649):
        warmup epochs sync every batch; the end of warmup sets
        (global_skip, local_skip, batches_to_wait) to (4, 1, 1); the last
        ``cooldown_epochs`` sync every batch; a plateau while
        ``global_skip > 1`` divides the skips by ``skip_reduction_factor``,
        and one at ``global_skip == 1`` widens them back to
        ``max_global_skips``. A loss that is not the global average is
        averaged over the ranks first (one all-reduce), so that every rank
        takes the same decision."""
        avg_loss = float(loss)
        if not loss_globally_averaged and self.comm.is_distributed():
            avg_loss = float(self.comm.allreduce(torch.tensor([avg_loss], dtype=torch.float64))[0]) / self.comm.size
        self.epoch += 1
        epoch = self.epoch - 1
        if epoch < self.warmup_epochs:
            self.global_skip = self.local_skip = self.batches_to_wait = 0
            return
        if epoch == self.warmup_epochs:
            self.global_skip, self.local_skip, self.batches_to_wait = 4, 1, 1
        if self.total_epochs is not None and epoch >= self.total_epochs - self.cooldown_epochs:
            self.global_skip = self.local_skip = self.batches_to_wait = 0
            return
        stable = self.stability.test_if_improving(avg_loss)
        if stable and self.global_skip > 1:
            self.global_skip //= self.skip_reduction_factor
            self.local_skip //= self.skip_reduction_factor
            self.batches_to_wait -= 1
            if self.global_skip > 0:
                if self.batches_to_wait == 0:
                    self.batches_to_wait = 1
                if self.local_skip == 0:
                    self.local_skip = 1
        elif stable and self.global_skip == 1:
            self.global_skip = self.max_gs
            self.local_skip = self.max_gs // self.local_skip_factor
            self.batches_to_wait = self.max_gs // self.local_skip_factor
