"""Kernels 7-9: the fused grouped-GEMM MoE dispatch, forward, dX and dW
(CUDA, ``csrc/moe_grouped_gemm.cu``).

Replaces ``paddle_tpu/ops/pallas/moe_grouped_gemm.py``: ``_fwd_call``
(its ``pallas_call`` at :263), ``_dx_call`` (:371) and ``_dw_call``
(:485). The expert FFNs read the routed token rows straight out of the
``[T, D]`` activations by a per-slot row map and scatter-add their
gate-weighted outputs straight into the ``[T, D]`` result: no
``[E, capacity, D]`` buffer on either side. See the source for what
bounds the kernels on the H100 and how the designs answer that.

Each slot ``(e, s)`` of the ``[E, cpad]`` maps (:func:`slot_maps`) names
its source token ``row_id`` (``T`` for an empty slot) and its combine
weight ``gate_w`` (0 for an empty slot).

- :func:`moe_fwd_plain`, :func:`moe_dx_plain`, :func:`moe_dw_plain` —
  the plain PyTorch versions, in the arithmetic of the Pallas kernels
  (fp32 products of x-dtype operands; h, dy, dh1 and dhg rounded to x's
  dtype before the products that take them; gate weight and scatter-add
  in fp32). An empty slot gathers row ``T - 1`` and adds 0, as there.
- :func:`moe_fwd_cuda`, :func:`moe_dx_cuda`, :func:`moe_dw_cuda` — the
  kernels' wrappers; each launches on bf16 or fp32 CUDA tensors (x, g
  and the three weights of one dtype) or raises outside
  :func:`kernel_gate`, and counts its calls (one call enqueues the
  kernel's passes: 2 for the forward, 3 for dX, 1 for dW; the fp32
  passes add the launches that split their B operands) in
  ``.launches`` (bf16) or ``.fp32_launches`` (fp32, the 3xTF32 mode).
  bf16 forward, dX and dW run on Hopper's wgmma with TMA-fed tiles; fp32
  forward, dX and dW on TF32 wgmma (three passes a product, the weights,
  or dW's h, dh1 and dhg, split into tf32 hi and lo once a call into
  scratch that the wrapper allocates: 6 or 4 x ``E D H`` floats for the
  forward, 12 or 8 for dX, 6 or 4 x ``E cpad H`` for dW).
- The dX pass hands dW what both Pallas passes recompute: ``h``, ``dh1``
  and ``dhg`` per slot, rounded to x's dtype (``inter``; in fp32 nothing
  is rounded). The dW pass takes them instead of recomputing them.
- :func:`fused_grouped_moe` — the differentiable function (counterpart
  of the JAX ``custom_vjp``): gradients for x, ``gate_w`` and the three
  expert weights.

Copied from the JAX module so that both packages choose the fused path
on the same shapes: :func:`slot_maps`, :func:`padded_capacity`,
:func:`act_name_of`, :func:`fused_dispatch_applicable`.
"""

from __future__ import annotations

import ctypes

import torch

from .build import library
from .routing import use_kernel

__all__ = ["fused_grouped_moe", "fused_dispatch_applicable", "slot_maps",
           "padded_capacity", "act_name_of", "moe_fwd_plain",
           "moe_dx_plain", "moe_dw_plain", "moe_fwd_cuda", "moe_dx_cuda",
           "moe_dw_cuda", "kernel_gate", "ACTS"]

_BC = 128                   # the JAX kernels' capacity block
_VMEM_BUDGET = 14 * 2 ** 20
_SMEM_BUDGET = 256 * 2 ** 10
ACTS = ("silu", "relu")
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
_DTYPE_CODE = {torch.bfloat16: 1, torch.float32: 0}   # C interface codes


def act_name_of(activation) -> str | None:
    """``moe_grouped_gemm.py:99``: the name of a known activation."""
    name = getattr(activation, "__name__", None)
    return name if name in ACTS else None


def _block_c(capacity: int) -> int:
    if capacity >= _BC:
        return _BC
    return max(8, -(-int(capacity) // 8) * 8)


def padded_capacity(capacity: int) -> int:
    bc = _block_c(capacity)
    return -(-int(capacity) // bc) * bc


def fused_dispatch_applicable(T, D, H, E, capacity, dtype, activation,
                              gated) -> bool:
    """The JAX package's gate (``moe_grouped_gemm.py:116``), copied with
    its TPU budgets: the port takes the fused path exactly where the JAX
    package does. The CUDA kernels have their own gate
    (:func:`kernel_gate`) and raise outside it."""
    if act_name_of(activation) is None:
        return False
    if dtype not in _ITEMSIZE:
        return False
    if D % 128 or D <= 0 or H <= 0 or T <= 0:
        return False
    cpad = padded_capacity(capacity)
    if E * cpad * 4 > _SMEM_BUDGET:
        return False
    n_w = 3 if gated else 2
    bc = _block_c(capacity)
    acc = (2 if gated else 1) * D * H * 4
    vmem = n_w * D * H * _ITEMSIZE[dtype] + acc + 2 * bc * D * 4
    return vmem <= _VMEM_BUDGET


def slot_maps(slot, fill_copy, occupied, w_flat, T, E, cpad, K):
    """``moe_grouped_gemm.py:148``: ``row_id`` int32 ``[E, cpad]`` (the
    source token per slot, ``T`` for an empty one) and ``gate_w`` fp32
    ``[E, cpad]`` (the combine weight, 0 for an empty slot), the latter
    built by a differentiable scatter so that the per-slot gate gradient
    flows back to the per-copy weights (dropped copies get exactly 0)."""
    ec = E * cpad
    row_id = torch.where(occupied, torch.div(fill_copy, K,
                                             rounding_mode="floor"),
                         torch.full_like(fill_copy, T)).int()
    gate_w = torch.zeros((ec + 1,), dtype=torch.float32,
                         device=w_flat.device).index_put(
        (slot,), w_flat.float())[:ec]
    return row_id.reshape(E, cpad), gate_w.reshape(E, cpad)


# ---------------- the plain versions ----------------

def _act(name, v):
    if name == "silu":
        return v * torch.sigmoid(v)
    if name == "relu":
        return torch.clamp(v, min=0.0)
    raise ValueError(name)


def _dact(name, v):
    if name == "silu":
        s = torch.sigmoid(v)
        return s * (1.0 + v * (1.0 - s))
    if name == "relu":
        return (v > 0).to(v.dtype)
    raise ValueError(name)


def _round(v, dtype):
    """v rounded to ``dtype`` and back (a product's operand)."""
    return v.to(dtype).to(v.dtype)


def _gather(t, row_id):
    """Rows of ``t`` by slot, ``[E, cpad, D]`` in fp32 (fp64 for fp64
    ``t``, the reference use); the sentinel ``T`` gathers row ``T - 1``
    (moe_grouped_gemm.py:200)."""
    cd = torch.float64 if t.dtype == torch.float64 else torch.float32
    return t[row_id.long().clamp(max=t.shape[0] - 1)].to(cd)


def _forward_parts(x, row_id, w_in, w_gate, act_name):
    xf = _gather(x, row_id)
    h1 = torch.bmm(xf, w_in.to(xf.dtype))
    if w_gate is not None:
        hg = torch.bmm(xf, w_gate.to(xf.dtype))
        return xf, h1, hg, _act(act_name, hg) * h1
    return xf, h1, None, _act(act_name, h1)


def _scatter_add(rows, row_id, T):
    """``[T, D]`` in rows' dtype: each slot's row added into its token's
    row; empty slots land in the trash row ``T`` and are cut off."""
    D = rows.shape[-1]
    out = torch.zeros((T + 1, D), dtype=rows.dtype, device=rows.device)
    out.index_add_(0, row_id.reshape(-1).long(), rows.reshape(-1, D))
    return out[:T]


def moe_fwd_plain(x, row_id, gate_w, w_in, w_gate, w_out, act_name):
    """fp32 ``[T, D]`` routed-expert output before its cast to x's dtype
    (``_fwd_kernel``, moe_grouped_gemm.py:179-229). The plain versions
    compute in fp32, or in fp64 for fp64 inputs (a reference)."""
    _, _, _, h = _forward_parts(x, row_id, w_in, w_gate, act_name)
    y = torch.bmm(_round(h, x.dtype), w_out.to(h.dtype))
    return _scatter_add(y * gate_w.to(h.dtype)[..., None], row_id,
                        x.shape[0])


def moe_dx_plain(x, row_id, gate_w, w_in, w_gate, w_out, g, act_name):
    """``(dx, dgw, inter)`` (``_dx_kernel``, :280-359): dx fp32 ``[T,
    D]``; dgw fp32 ``[E, cpad]``, ``<g[row_s], y_s>`` with y un-weighted
    (an empty slot's value is not used); ``inter = (h, dh1, dhg)``, each
    ``[E, cpad, H]`` in x's dtype (dhg None when ungated), the values the
    dW pass multiplies."""
    xf, h1, hg, h = _forward_parts(x, row_id, w_in, w_gate, act_name)
    cd = h.dtype
    hr = _round(h, x.dtype)
    gf = _gather(g, row_id)
    dgw = (gf * torch.bmm(hr, w_out.to(cd))).sum(dim=-1)
    dy = _round(gf * gate_w.to(cd)[..., None], x.dtype)
    dh = torch.bmm(dy, w_out.to(cd).transpose(1, 2))
    if w_gate is not None:
        ag = _act(act_name, hg)
        dh1 = _round(dh * ag, x.dtype)
        dhg = _round(dh * h1 * _dact(act_name, hg), x.dtype)
        dxr = (torch.bmm(dh1, w_in.to(cd).transpose(1, 2))
               + torch.bmm(dhg, w_gate.to(cd).transpose(1, 2)))
    else:
        dh1 = _round(dh * _dact(act_name, h1), x.dtype)
        dhg = None
        dxr = torch.bmm(dh1, w_in.to(cd).transpose(1, 2))
    inter = tuple(None if t is None else t.to(x.dtype)
                  for t in (hr, dh1, dhg))
    return _scatter_add(dxr, row_id, x.shape[0]), dgw, inter


def moe_dw_plain(x, row_id, gate_w, g, inter):
    """``(dw_in, dw_gate, dw_out)`` in fp32 (``_dw_kernel``, :392-450):
    per expert ``x^T dh1``, ``x^T dhg`` and ``h^T dy`` summed over its
    slots, ``dy = g * gate_w`` rounded to x's dtype; dw_gate None when
    ungated."""
    h, dh1, dhg = inter
    xt = _gather(x, row_id).transpose(1, 2)
    cd = xt.dtype
    dy = _round(_gather(g, row_id) * gate_w.to(cd)[..., None], x.dtype)
    dwo = torch.bmm(h.to(cd).transpose(1, 2), dy)
    dwi = torch.bmm(xt, dh1.to(cd))
    dwg = None if dhg is None else torch.bmm(xt, dhg.to(cd))
    return dwi, dwg, dwo


# ---------------- the kernels' wrappers ----------------

_ACT_CODE = {"silu": 0, "relu": 1}


def _maps_gate(x, row_id, gate_w, g, H) -> str | None:
    """The checks the three passes share: x (and g) bf16 or fp32 ``[T,
    D]``, the slot maps, and the kernels' tile rules for D and H."""
    ts = [t for t in (x, row_id, gate_w, g) if t is not None]
    if not all(t.is_cuda and t.device == x.device for t in ts):
        return "all inputs must be on one CUDA device"
    if not all(t.is_contiguous() for t in ts):
        return "all inputs must be contiguous"
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE or (
            g is not None and (g.dtype != x.dtype or g.shape != x.shape)):
        return ("x (and g, of x's shape and dtype) must be bfloat16 or "
                "float32 [T, D] (the kernels' two modes, ROADMAP B4)")
    T, D = x.shape
    if D <= 0 or H <= 0 or D % 64 or H % 32:
        return f"D must be a multiple of 64 and H of 32; got D {D}, H {H}"
    if (row_id.dim() != 2 or row_id.dtype != torch.int32
            or gate_w.shape != row_id.shape
            or gate_w.dtype != torch.float32):
        return "row_id must be int32 [E, cpad] and gate_w float32 [E, cpad]"
    if not 0 < T < 2 ** 31 // D or row_id.shape[0] > 65535 or \
            row_id.shape[1] > 64 * 65535:
        return "shape outside the kernels' index range"
    return None


def kernel_gate(x, row_id, gate_w, w_in, w_gate, w_out, act_name,
                g=None) -> str | None:
    """None when the forward and dX kernels take these inputs, else the
    reason."""
    if w_in.dim() != 3 or x.dim() != 2:
        return "x must be [T, D] and the expert weights [E, D, H]"
    E, D, H = w_in.shape
    why = _maps_gate(x, row_id, gate_w, g, H)
    if why is not None:
        return why
    ws = [w for w in (w_in, w_gate, w_out) if w is not None]
    if not all(w.is_cuda and w.device == x.device and w.is_contiguous()
               and w.dtype == x.dtype for w in ws):
        return ("the expert weights must be contiguous, on x's device and "
                "of x's dtype")
    if (D != x.shape[1] or row_id.shape[0] != E
            or tuple(w_out.shape) != (E, H, D)
            or (w_gate is not None and w_gate.shape != w_in.shape)):
        return (f"weights must be [E, D, H] / [E, H, D] for x [T, "
                f"{x.shape[1]}] and row_id [E, cpad]; got "
                f"{tuple(w_in.shape)}, {tuple(w_out.shape)}, "
                f"{tuple(row_id.shape)}")
    if act_name not in _ACT_CODE:
        return f"activation must be one of {ACTS}; got {act_name!r}"
    return None


def _check(name, *args, **kw):
    why = kernel_gate(*args, **kw)
    if why is not None:
        raise ValueError(f"{name}: {why}")


def _fn(sym: str, n_ptr: int, n_int: int):
    fn = getattr(library("moe_grouped_gemm"), sym)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _dims(x, row_id, w_in, act_name, gated):
    T, D = x.shape
    E, cpad = row_id.shape
    return [T, D, w_in.shape[2], E, cpad, _ACT_CODE[act_name], int(gated),
            _DTYPE_CODE[x.dtype]]


def _count(fn, x):
    """One more launch of fn's mode: ``.fp32_launches`` for fp32 x."""
    attr = "fp32_launches" if x.dtype == torch.float32 else "launches"
    setattr(fn, attr, getattr(fn, attr) + 1)


def _scratch(x, n):
    """The fp32 kernels' scratch (``n`` floats: the tf32 hi and lo of their
    B operands); None for bf16, whose kernels take none."""
    if x.dtype != torch.float32:
        return None
    return torch.empty((n,), dtype=torch.float32, device=x.device)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def moe_fwd_cuda(x, row_id, gate_w, w_in, w_gate, w_out, act_name):
    """Launch the forward: fp32 ``[T, D]`` as :func:`moe_fwd_plain`."""
    _check("moe_fwd_cuda", x, row_id, gate_w, w_in, w_gate, w_out, act_name)
    E, cpad = row_id.shape
    h = torch.empty((E * cpad, w_in.shape[2]), dtype=x.dtype,
                    device=x.device)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    scratch = _scratch(x, (6 if w_gate is not None else 4) * E
                       * x.shape[1] * w_in.shape[2])
    with torch.cuda.device(x.device):
        err = _fn("moe_fwd_launch", 9, 8)(
            _ptr(x), _ptr(row_id), _ptr(gate_w), _ptr(w_in), _ptr(w_gate),
            _ptr(w_out), _ptr(h), _ptr(out), _ptr(scratch),
            *_dims(x, row_id, w_in, act_name, w_gate is not None),
            _stream(x.device))
    _raise_on(err, "moe grouped forward")
    _count(moe_fwd_cuda, x)
    return out


def moe_dx_cuda(x, row_id, gate_w, w_in, w_gate, w_out, g, act_name):
    """Launch the dX passes: ``(dx, dgw, inter)`` as
    :func:`moe_dx_plain`, except that an empty slot's ``inter`` rows and
    ``dgw`` are 0 (the fp32 kernels skip the slot blocks that hold no
    token, so ``inter`` starts zeroed there; the bf16 ones write the
    zeros of such a block themselves)."""
    _check("moe_dx_cuda", x, row_id, gate_w, w_in, w_gate, w_out, act_name,
           g=g)
    E, cpad = row_id.shape
    H, D = w_in.shape[2], x.shape[1]
    alloc = torch.zeros if x.dtype == torch.float32 else torch.empty
    inter = [alloc((E, cpad, H), dtype=x.dtype, device=x.device)
             for _ in range(3 if w_gate is not None else 2)]
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dgw = torch.empty((E, cpad), dtype=torch.float32, device=x.device)
    part = torch.empty((D // 64, E * cpad), dtype=torch.float32,
                       device=x.device)
    dhg = inter[2] if w_gate is not None else None
    scratch = _scratch(x, (12 if w_gate is not None else 8) * E * D * H)
    with torch.cuda.device(x.device):
        err = _fn("moe_dx_launch", 14, 8)(
            _ptr(x), _ptr(row_id), _ptr(gate_w), _ptr(w_in), _ptr(w_gate),
            _ptr(w_out), _ptr(g), _ptr(inter[0]), _ptr(inter[1]), _ptr(dhg),
            _ptr(dx), _ptr(dgw), _ptr(part), _ptr(scratch),
            *_dims(x, row_id, w_in, act_name, w_gate is not None),
            _stream(x.device))
    _raise_on(err, "moe grouped dX")
    _count(moe_dx_cuda, x)
    return dx, dgw, (inter[0], inter[1], dhg)


def moe_dw_cuda(x, row_id, gate_w, g, inter):
    """Launch the dW pass: ``(dw_in, dw_gate, dw_out)`` in x's dtype,
    each the per-expert fp32 sum rounded once (bf16) or as summed
    (fp32)."""
    h, dh1, dhg = inter
    E, cpad = row_id.shape
    H = h.shape[-1]
    if not (h.shape == dh1.shape == (E, cpad, H)
            and (dhg is None or dhg.shape == h.shape)):
        raise ValueError("moe_dw_cuda: inter must be [E, cpad, H] tensors "
                         "from moe_dx_cuda")
    D = x.shape[1]
    why = _maps_gate(x, row_id, gate_w, g, H)
    if why is None and not all(
            t.is_cuda and t.device == x.device and t.dtype == x.dtype
            and t.is_contiguous() for t in inter if t is not None):
        why = "inter must be contiguous tensors in x's dtype on x's device"
    if why is not None:
        raise ValueError(f"moe_dw_cuda: {why}")
    dwi = torch.empty((E, D, H), dtype=x.dtype, device=x.device)
    dwg = None if dhg is None else torch.empty_like(dwi)
    dwo = torch.empty((E, H, D), dtype=x.dtype, device=x.device)
    scratch = _scratch(x, (6 if dhg is not None else 4) * E * cpad * H)
    with torch.cuda.device(x.device):
        err = _fn("moe_dw_launch", 11, 6)(
            _ptr(x), _ptr(row_id), _ptr(gate_w), _ptr(g), _ptr(h),
            _ptr(dh1), _ptr(dhg), _ptr(dwi), _ptr(dwg), _ptr(dwo),
            _ptr(scratch),
            x.shape[0], D, H, E, cpad, _DTYPE_CODE[x.dtype],
            _stream(x.device))
    _raise_on(err, "moe grouped dW")
    _count(moe_dw_cuda, x)
    return dwi, dwg, dwo


moe_fwd_cuda.launches = moe_fwd_cuda.fp32_launches = 0
moe_dx_cuda.launches = moe_dx_cuda.fp32_launches = 0
moe_dw_cuda.launches = moe_dw_cuda.fp32_launches = 0


# ---------------- the differentiable function ----------------

class _FusedGroupedMoe(torch.autograd.Function):
    """Counterpart of ``fused_grouped_moe`` / ``_fused_fwd`` /
    ``_fused_bwd`` (moe_grouped_gemm.py:511-551)."""

    @staticmethod
    def forward(ctx, x, row_id, gate_w, w_in, w_gate, w_out, act_name):
        if use_kernel(x):
            out = moe_fwd_cuda(x, row_id, gate_w, w_in, w_gate, w_out,
                               act_name)
        else:
            out = moe_fwd_plain(x, row_id, gate_w, w_in, w_gate, w_out,
                                act_name)
        ctx.save_for_backward(x, row_id, gate_w, w_in, w_gate, w_out)
        ctx.act_name = act_name
        ctx.mark_non_differentiable(row_id)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, row_id, gate_w, w_in, w_gate, w_out = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        if use_kernel(x):
            dx, dgw, inter = moe_dx_cuda(x, row_id, gate_w, w_in, w_gate,
                                         w_out, g, ctx.act_name)
            dwi, dwg, dwo = moe_dw_cuda(x, row_id, gate_w, g, inter)
        else:
            dx, dgw, inter = moe_dx_plain(x, row_id, gate_w, w_in, w_gate,
                                          w_out, g, ctx.act_name)
            dwi, dwg, dwo = moe_dw_plain(x, row_id, gate_w, g, inter)
        return (dx.to(x.dtype), None, dgw, dwi.to(w_in.dtype),
                None if w_gate is None else dwg.to(w_gate.dtype),
                dwo.to(w_out.dtype), None)


def fused_grouped_moe(x, row_id, gate_w, w_in, w_gate, w_out, act_name):
    """Routed-expert output ``[T, D]`` in x's dtype from x ``[T, D]`` and
    the per-slot maps (:func:`slot_maps`): gather, grouped GEMMs,
    gate-weighted scatter-add. ``w_gate`` may be None (ungated FFN);
    ``act_name`` comes from :func:`act_name_of`."""
    return _FusedGroupedMoe.apply(x, row_id, gate_w, w_in, w_gate, w_out,
                                  act_name)
