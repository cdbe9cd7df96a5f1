"""Loss functionals (counterpart: paddle_tpu/nn/functional/loss.py).

Only the hard-label softmax cross entropy is ported: integer labels, no
class weights, no label smoothing, softmax on, class axis last — the
branch a causal-LM loss takes. The other branches raise.
"""

from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


class _HardCE(torch.autograd.Function):
    """Counterpart of ``_hard_ce`` (loss.py:32-59): the forward saves the
    logits, the labels and the fp32 per-row logsumexp, never an
    ``[N, vocab]`` log-softmax; the gradient comes back in the logits'
    dtype."""

    @staticmethod
    def forward(ctx, x, label, ignore_index):
        valid = label != ignore_index
        safe = torch.where(valid, label, torch.zeros_like(label)).long()
        xf = x.float()
        lse = torch.logsumexp(xf, dim=-1)
        picked = xf.gather(-1, safe[..., None])[..., 0]
        ctx.save_for_backward(x, safe, valid, lse)
        return torch.where(valid, lse - picked, torch.zeros_like(lse))

    @staticmethod
    def backward(ctx, g):
        x, safe, valid, lse = ctx.saved_tensors
        scale = (g * valid.float())[..., None]
        dx = torch.exp(x.float() - lse[..., None])
        dx.scatter_add_(-1, safe[..., None],
                        -torch.ones_like(lse)[..., None])   # p - onehot
        return (dx * scale).to(x.dtype), None, None


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross entropy over integer labels (counterpart: loss.py:62).
    fp32 logsumexp whatever the logits' dtype; labels equal to
    ``ignore_index`` add nothing, and ``"mean"`` divides by the number of
    the other labels (at least 1)."""
    if (weight is not None or soft_label or label_smoothing
            or not use_softmax or axis not in (-1, input.dim() - 1)):
        raise NotImplementedError(
            "only the hard-label cross entropy (no weight, no smoothing, "
            "softmax on, last axis) is ported")
    lab = label
    if lab.dim() == input.dim() and lab.shape[-1] == 1:
        lab = lab.squeeze(-1)
    if lab.dim() != input.dim() - 1 or lab.is_floating_point():
        raise NotImplementedError("labels must be integer class ids with "
                                  "the logits' shape minus the class axis")
    loss = _HardCE.apply(input, lab, int(ignore_index))
    if reduction == "mean":
        n_valid = (lab != ignore_index).sum().float()
        return loss.sum() / torch.clamp(n_valid, min=1.0)
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")
