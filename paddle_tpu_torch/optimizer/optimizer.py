"""Adam and AdamW (counterpart: paddle_tpu/optimizer/optimizer.py).

The same functional pair as the JAX package, over name-keyed dicts:
``init_state(params) -> state`` and ``update(params, grads, state, lr)``.
The state is ``{"step": int, "moment1": {name: fp32}, "moment2": {name:
fp32}, "master": {name: fp32 or None}}``; with ``multi_precision`` every
floating parameter that is not fp32 keeps an fp32 master copy, updated in
fp32 and rounded once into the parameter.

Unlike the JAX package, :meth:`Optimizer.update` works IN PLACE: it
writes the parameters, moments and master copies it is given and returns
the same dicts. Plain tensor code (the JAX package leaves the update to
one XLA fusion; there is no kernel to port). The optimizer holds its own
state in ``Optimizer.state`` once a :class:`~paddle_tpu_torch.jit.TrainStep`
has run or ``models.weights.load_optimizer_state`` has filled it.

Ported: a constant float learning rate, no gradient clipping.
``LRScheduler`` and ``grad_clip`` wait (ROADMAP.md A2).
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["Optimizer", "Adam", "AdamW"]


class Optimizer:
    slots: tuple[str, ...] = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None,
                 multi_precision: bool = True):
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (int, float)):
            raise NotImplementedError(
                "only a constant float learning rate is ported; LR "
                "schedulers wait (ROADMAP.md A2)")
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported yet "
                                      "(ROADMAP.md A2)")
        if parameters is not None and not isinstance(parameters, nn.Module):
            raise TypeError("parameters must be the model (an nn.Module) or "
                            "None for the functional init_state/update")
        self._lr = float(learning_rate)
        self.weight_decay = 0.0 if weight_decay is None else weight_decay
        self.multi_precision = multi_precision
        self.params = ({} if parameters is None else
                       {k: p for k, p in parameters.named_parameters()
                        if p.requires_grad})
        self.state: dict | None = None

    def get_lr(self, step=None) -> float:
        return self._lr

    def init_state(self, params: dict[str, torch.Tensor]) -> dict:
        state = {"step": 0}
        for slot in self.slots:
            state[slot] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                           for k, p in params.items()}
        if self.multi_precision:
            state["master"] = {
                k: (p.detach().float().clone()
                    if p.is_floating_point() and p.dtype != torch.float32
                    else None)
                for k, p in params.items()}
        return state

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict, lr=None):
        """One step, in place (see the module docstring); ``grads`` may
        name a subset of ``params`` and hold None for frozen ones."""
        step = state["step"] + 1
        lr_t = float(lr if lr is not None else self.get_lr(step))
        for k, g in grads.items():
            if g is None:
                continue
            p = params[k]
            master = (state.get("master", {}).get(k)
                      if self.multi_precision else None)
            if master is not None:
                p32 = master
            elif p.dtype == torch.float32:
                p32 = p
            else:
                p32 = p.float()
            self._rule(p32, g.float(), {s: state[s][k] for s in self.slots},
                       lr_t, step, key=k)
            if p32 is not p:
                p.copy_(p32)
        state["step"] = step
        return params, state

    def _rule(self, p, g, slots, lr, step, key=None):
        """Update the fp32 ``p`` and the ``slots`` in place."""
        raise NotImplementedError


class Adam(Optimizer):
    slots = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _decay(self, p, g, lr):
        """Coupled L2 decay (counterpart: ``Optimizer._wd``)."""
        return g + self.weight_decay * p if self.weight_decay else g

    def _rule(self, p, g, slots, lr, step, key=None):
        g = self._decay(p, g, lr)
        m, v = slots["moment1"], slots["moment2"]
        m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
        v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
        # bias corrections in fp32 as in the JAX package (t is 1-based)
        t = torch.tensor(float(step), dtype=torch.float32)
        bc1 = float(1 - torch.tensor(self.beta1, dtype=torch.float32) ** t)
        bc2 = float(1 - torch.tensor(self.beta2, dtype=torch.float32) ** t)
        upd = m / bc1
        upd.mul_(lr).div_((v / bc2).sqrt_().add_(self.epsilon))
        p.sub_(upd)


class AdamW(Adam):
    """Decoupled weight decay (counterpart: optimizer.py:217): the
    parameter decays by ``1 - lr * weight_decay`` first, then the Adam
    step."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, multi_precision=True):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, multi_precision)
        self.weight_decay = weight_decay or 0.0

    def _decay(self, p, g, lr):
        if self.weight_decay:
            p.mul_(1 - lr * self.weight_decay)
        return g
