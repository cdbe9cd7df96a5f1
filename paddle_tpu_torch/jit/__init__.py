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
    the batch, also inside (nested) tuples and lists, are moved to the
    model's device. A trainable parameter that the loss does not reach
    gets a zero gradient, as ``jax.value_and_grad`` gives it in the JAX
    package, so AdamW still applies its decoupled decay to it. The
    gradients of the last step stay in each parameter's ``.grad`` until
    the next call.

    The step runs the model in training mode, as the JAX ``TrainStep``
    calls ``functional_call(..., training=True)`` (jit/__init__.py:124),
    and puts back the mode it found. Random draws (dropout) come from the
    generators the model's layers hold, not from a key the step draws:
    the same draws in the same order whether the kernels or their plain
    versions (``plain_reference()``) run, so a parity run that restores a
    generator's state draws the same masks on both sides.

    Not ported: ``has_aux``, grad hooks, fault-injection sites and
    ``PipelineTrainStep``."""

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
        if isinstance(x, (tuple, list)):
            return type(x)(self._as_tensor(v) for v in x)
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
        was_training = self.model.training
        self.model.train()
        try:
            loss = self.loss_fn(self.model(*inputs), *labels)
        finally:
            self.model.train(was_training)
        loss.backward()
        for p in self._params.values():
            if p.grad is None:          # unused by this loss: a zero grad
                p.grad = torch.zeros_like(p)
        grads = {k: p.grad for k, p in self._params.items()}
        opt.update(self._params, grads, opt.state,
                   lr=opt.get_lr(self.host_step + 1))
        self.host_step += 1
        return loss.detach()
