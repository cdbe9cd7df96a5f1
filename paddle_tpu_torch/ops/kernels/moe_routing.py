"""Kernel 6: fused top-2 MoE routing (CUDA, ``csrc/moe_routing.cu``).

Replaces ``paddle_tpu/ops/pallas/moe_routing.py::_run_kernel`` (its
``pallas_call`` at :147): the routing front-end of the fused grouped-GEMM
dispatch. See the source for what bounds it on the H100 and how the
design answers that.

- :func:`routing_plain` — the plain PyTorch version of the kernel body:
  softmax, first-tie top-1 / top-2, the random keep of the second expert
  from passed-in uniforms, and first-come-first-served positions (every
  top-1 claim before every top-2 claim) by per-expert running counts over
  all tokens in token order;
- :func:`moe_routing_cuda` — the kernel's wrapper: launches on a CUDA
  tensor or raises; ``moe_routing_cuda.launches`` counts its launches;
  one launch a call, its blocks handing the running counts on through a
  workspace that the wrapper keeps a device and stream (:func:`_work`);
- :func:`fused_top2_routing` — the differentiable routing (counterpart
  of the JAX ``custom_vjp`` of the same name): the kernel (or its plain
  version on a CPU tensor) plus the capacity / renormalisation / aux
  epilogue, a few elementwise ops in both packages; its backward is the
  closed form of ``_fused_bwd`` (moe_routing.py:193), XLA code there and
  torch code here;
- :func:`fused_routing_applicable` — the JAX package's shape gate,
  copied, so that both packages take the kernel on the same shapes.
"""

from __future__ import annotations

import ctypes

import torch

from .build import library
from .routing import use_kernel

__all__ = ["routing_plain", "moe_routing_cuda", "fused_top2_routing",
           "fused_routing_applicable", "top2_epilogue", "MAX_E"]

_BT = 1024     # the JAX kernel's token block; T must be a multiple of it
MAX_E = 128


def fused_routing_applicable(T, E) -> bool:
    """The JAX package's gate (moe_routing.py:225), copied."""
    return T % _BT == 0 and _BT <= T <= 65536 and E <= 128


def top2_epilogue(g1, g2, keep1, keep2f):
    """``_top2_epilogue`` (distributed/moe.py:114): the raw top-2 probs,
    zeroed for capacity-dropped copies, renormalised over the kept
    experts."""
    denom = torch.clamp(g1 * keep1 + g2 * keep2f, min=1e-9)
    w1 = torch.where(keep1, g1, torch.zeros_like(g1)) / denom
    w2 = torch.where(keep2f, g2, torch.zeros_like(g2)) / denom
    return w1, w2


def routing_plain(logits: torch.Tensor, u: torch.Tensor | None,
                  random_keep2: bool):
    """The kernel's nine outputs ``(g1i, g2i, g1, g2, p1, c2, keep2,
    count1, me_sum)``: int32 / fp32 ``[T]`` vectors and fp32 ``[E]``
    counts and probability sums, in the arithmetic of ``_routing_kernel``
    (moe_routing.py:51-126). ``p1`` and ``c2`` are 0-based positions
    among the expert's top-1 (top-2) claims; ``c2`` is 0 where the second
    expert is not kept."""
    lg = logits.float()
    T, E = lg.shape
    mx = lg.amax(dim=1, keepdim=True)
    ex = torch.exp(lg - mx)
    probs = ex / ex.sum(dim=1, keepdim=True)
    iota = torch.arange(E, device=lg.device)
    none = torch.full_like(iota, E)
    g1v = probs.amax(dim=1, keepdim=True)
    g1i = torch.where(probs >= g1v, iota, none).amin(dim=1)   # first tie
    m1 = iota == g1i[:, None]
    pw = torch.where(m1, torch.zeros_like(probs), probs)
    g2v = pw.amax(dim=1, keepdim=True)
    g2i = torch.where(pw >= g2v, iota, none).amin(dim=1)
    m2 = iota == g2i[:, None]
    g1 = torch.where(m1, probs, torch.zeros_like(probs)).sum(dim=1)
    g2 = torch.where(m2, pw, torch.zeros_like(pw)).sum(dim=1)
    if random_keep2:
        keep2 = u.float() < 2.0 * g2 / torch.clamp(g1 + g2, min=1e-9)
    else:
        keep2 = torch.ones((T,), dtype=torch.bool, device=lg.device)
    mask1 = m1.int()
    mask2 = m2.int() * keep2.int()[:, None]
    p1 = ((torch.cumsum(mask1, dim=0) - 1) * mask1).sum(dim=1)
    c2 = ((torch.cumsum(mask2, dim=0) - 1) * mask2).sum(dim=1)
    return (g1i.int(), g2i.int(), g1, g2, p1.int(), c2.int(), keep2.int(),
            mask1.sum(dim=0).float(), probs.sum(dim=0))


def _fn():
    fn = library("moe_routing").moe_routing_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


_WORK: dict = {}


def _work(dev, stream) -> torch.Tensor:
    """The kernel's workspace for ``stream`` on ``dev``: its tile ticket,
    ready flags and per-tile counts, zeroed once; every call leaves it
    zeroed again, so calls in one stream need no reset between them."""
    key = (dev, stream)
    if key not in _WORK:
        size = library("moe_routing").moe_routing_work_bytes
        size.restype = ctypes.c_size_t
        _WORK[key] = torch.zeros((size(),), dtype=torch.uint8, device=dev)
    return _WORK[key]


def moe_routing_cuda(logits: torch.Tensor, u: torch.Tensor | None,
                     random_keep2: bool):
    """Launch the routing kernel: the nine outputs of
    :func:`routing_plain`. Takes fp32 ``[T, E]`` logits with
    ``fused_routing_applicable(T, E)`` and, with ``random_keep2``, fp32
    ``[T]`` uniforms, all contiguous on one CUDA device; raises on
    anything else."""
    if logits.dim() != 2 or not logits.is_cuda:
        raise ValueError("moe_routing_cuda takes [T, E] logits on a CUDA "
                         "device")
    T, E = logits.shape
    if logits.dtype != torch.float32 or not logits.is_contiguous():
        raise ValueError(f"moe_routing_cuda takes contiguous float32 "
                         f"logits; got {logits.dtype}")
    if not fused_routing_applicable(T, E) or E < 2:
        raise ValueError(f"moe_routing_cuda takes T a multiple of {_BT} in "
                         f"[{_BT}, 65536] and 2 <= E <= {MAX_E}; got T {T}, "
                         f"E {E}")
    if random_keep2:
        if (u is None or u.shape != (T,) or u.dtype != torch.float32
                or u.device != logits.device or not u.is_contiguous()):
            raise ValueError("random_keep2 needs contiguous float32 [T] "
                             "uniforms on the logits' device")
    dev = logits.device
    ints = [torch.empty((T,), dtype=torch.int32, device=dev)
            for _ in range(2)]
    g1, g2 = (torch.empty((T,), dtype=torch.float32, device=dev)
              for _ in range(2))
    p1, c2, keep2 = (torch.empty((T,), dtype=torch.int32, device=dev)
                     for _ in range(3))
    count1, me_sum = (torch.empty((E,), dtype=torch.float32, device=dev)
                      for _ in range(2))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(logits.data_ptr(),
                    u.data_ptr() if random_keep2 else None,
                    ints[0].data_ptr(), ints[1].data_ptr(), g1.data_ptr(),
                    g2.data_ptr(), p1.data_ptr(), c2.data_ptr(),
                    keep2.data_ptr(), count1.data_ptr(), me_sum.data_ptr(),
                    _work(dev, stream).data_ptr(), T, E,
                    int(bool(random_keep2)), stream)
    if err != 0:
        raise RuntimeError(f"moe routing kernel launch failed: CUDA error "
                           f"{err}")
    moe_routing_cuda.launches += 1
    return (ints[0], ints[1], g1, g2, p1, c2, keep2, count1, me_sum)


moe_routing_cuda.launches = 0


def _run(logits, u, random_keep2):
    if use_kernel(logits):
        return moe_routing_cuda(logits.float().contiguous(), u, random_keep2)
    return routing_plain(logits, u, random_keep2)


class _FusedTop2(torch.autograd.Function):
    """Counterpart of ``fused_top2_routing`` / ``_fused_fwd`` /
    ``_fused_bwd`` (moe_routing.py:159-215)."""

    @staticmethod
    def forward(ctx, logits, u, capacity, random_keep2, blw):
        T, E = logits.shape
        g1i, g2i, g1, g2, p1, c2, keep2, count1, me_sum = _run(
            logits, u, random_keep2)
        g1i, g2i, p1 = g1i.long(), g2i.long(), p1.long()
        keep1 = p1 < capacity
        claimed2 = keep2 > 0
        p2 = torch.where(claimed2, c2.long() + count1.long()[g2i],
                         torch.zeros_like(p1))
        keep2f = (p2 < capacity) & claimed2
        w1, w2 = top2_epilogue(g1, g2, keep1, keep2f)
        ce = count1 / T
        aux = ((me_sum / T) * ce).sum() * E * blw
        ctx.save_for_backward(logits, g1i, g2i, g1, g2, keep1, keep2f, ce)
        ctx.blw = blw
        ctx.mark_non_differentiable(g1i, g2i, keep1, keep2f, p1, p2)
        return g1i, g2i, w1, w2, keep1, keep2f, p1, p2, aux

    @staticmethod
    def backward(ctx, _g1i, _g2i, dw1, dw2, _k1, _k2, _p1, _p2, daux):
        logits, g1i, g2i, g1, g2, keep1, keep2f, ce = ctx.saved_tensors
        T, E = logits.shape
        k1, k2 = keep1.float(), keep2f.float()
        s = k1 * g1 + k2 * g2
        live = (s >= 1e-9).float()       # max(s, eps) subgradient
        d = torch.clamp(s, min=1e-9)
        d2 = d * d
        dg1 = (dw1 * (k1 / d - k1 * k1 * g1 * live / d2)
               + dw2 * (-k2 * g2 * k1 * live / d2))
        dg2 = (dw2 * (k2 / d - k2 * k2 * g2 * live / d2)
               + dw1 * (-k1 * g1 * k2 * live / d2))
        probs = torch.softmax(logits.float(), dim=-1)
        dprobs = torch.zeros_like(probs)
        dprobs.scatter_add_(1, g1i[:, None], dg1[:, None])
        dprobs.scatter_add_(1, g2i[:, None], dg2[:, None])
        dprobs = dprobs + (daux * ctx.blw * E / T) * ce[None, :]
        dlogits = probs * (dprobs - (dprobs * probs).sum(dim=-1,
                                                         keepdim=True))
        return dlogits.to(logits.dtype), None, None, None, None


def fused_top2_routing(logits, u, capacity: int, random_keep2: bool,
                       balance_loss_weight: float):
    """The routing decision ``(g1_idx, g2_idx, w1, w2, keep1, keep2f, p1,
    p2, aux)`` of ``_top2_parts``: indices and positions int64, keeps
    bool, ``w1``/``w2``/``aux`` fp32 and differentiable in ``logits``."""
    return _FusedTop2.apply(logits, u, int(capacity), bool(random_keep2),
                            float(balance_loss_weight))
