"""The training step (counterpart: paddle_tpu/jit/__init__.py::TrainStep).

PyTorch runs eagerly, so there is no program to compile: each call runs
the forward, ``backward()`` and the optimizer's in-place update.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from ..optimizer import Optimizer

__all__ = ["TrainStep"]


class TrainStep:
    """``TrainStep(model, opt, loss_fn, n_inputs=1)``; ``step(*batch)``
    runs ``loss_fn(model(*batch[:n_inputs]), *batch[n_inputs:])``, its
    backward and ``opt.update`` at ``lr = opt.get_lr(host_step + 1)``,
    advances ``host_step`` and returns the detached loss. Numpy arrays in
    the batch are moved to the model's device. The gradients of the last
    step stay in each parameter's ``.grad`` until the next call.

    Not ported: ``has_aux``, grad hooks, fault-injection sites and
    ``PipelineTrainStep``; no PRNG key is drawn, as nothing on this path
    is random."""

    def __init__(self, model: nn.Module, optimizer: Optimizer,
                 loss_fn: Callable, n_inputs: int = 1):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.n_inputs = n_inputs
        self.host_step = 0
        self._params = {k: p for k, p in model.named_parameters()
                        if p.requires_grad}
        self._device = next(model.parameters()).device

    def _as_tensor(self, x):
        if isinstance(x, (np.ndarray, np.number, int, float)):
            return torch.as_tensor(np.asarray(x), device=self._device)
        return x

    def __call__(self, *batch):
        batch = tuple(self._as_tensor(x) for x in batch)
        inputs, labels = batch[:self.n_inputs], batch[self.n_inputs:]
        opt = self.optimizer
        if opt.state is None:
            opt.state = opt.init_state(self._params)
        for p in self._params.values():
            p.grad = None
        loss = self.loss_fn(self.model(*inputs), *labels)
        loss.backward()
        grads = {k: p.grad for k, p in self._params.items()}
        opt.update(self._params, grads, opt.state,
                   lr=opt.get_lr(self.host_step + 1))
        self.host_step += 1
        return loss.detach()
