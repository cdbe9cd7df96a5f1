"""The weight bridge and seeded random weights.

- :func:`load_numpy_state` loads a JAX model's
  ``state_dict(include_non_persistable_buffer=True)``, converted to
  ``{name: numpy array}``, into the port's model. Names and layouts are
  the same in both packages, so the only conversion is a dtype cast to
  the port parameter's dtype (an fp32 parameter, such as a MoE router's
  weight in a bf16 model, stays fp32). The persistent buffers of an
  ``Int8ServingLinear`` (``weight_q`` int8, ``weight_scale`` fp32) load
  too, never cast: a source of another dtype raises. The non-persistent
  rope tables (``[model.]rope_cos``/``[model.]rope_sin``) are loaded when
  present, so a test compares like with like; they are never required,
  and the MoE layers' ``*.moe.aux_loss`` buffers are skipped. Missing
  and extra keys and shape mismatches raise, naming the key.
- :func:`export_numpy_state` is its inverse: the model's parameters and
  persistent buffers as ``{name: numpy array}`` (bf16 values as exact
  fp32 arrays; int8 codes and fp32 scales as they are).
- :func:`load_optimizer_state` carries a JAX optimizer state, converted
  to numpy (``{"step", "moment1", "moment2", "master"}``), into the
  port's optimizer, so that both packages can continue from one
  mid-training state.
- :func:`init_random` draws every parameter on the model's own device
  from one ``torch.Generator`` seeded with ``seed``, using the JAX
  package's initialisers (XavierNormal for Linear weights and the MoE
  expert weights, zeros for Linear biases, XavierUniform for the fp32
  MoE router, N(0, 1) for Embedding, ones for RMSNorm, ones and zeros
  for LayerNorm), each in its parameter's own dtype. A tied weight (the
  BERT MLM decoder and the GPT LM head are the word embedding) is one
  parameter, drawn once. The draws differ from ``jax.random``'s
  for the same seed; tests that compare the two packages load the JAX
  weights instead.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["load_numpy_state", "export_numpy_state", "load_optimizer_state",
           "init_random"]

_OPTIONAL = ("model.rope_cos", "model.rope_sin", "rope_cos", "rope_sin")
# the JAX MoE layers' non-persistent buffer: the last forward's router
# loss, state of no weight; skipped when present
_SKIPPED_SUFFIX = ".moe.aux_loss"


def _to_tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.kind not in "fiub" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)   # e.g. ml_dtypes' bfloat16
    return torch.from_numpy(np.array(a, copy=True))


def load_numpy_state(model: nn.Module, state: dict) -> None:
    """Copy ``state`` into ``model``'s parameters and persistent buffers
    (and the optional rope buffers) in place. Raises KeyError on missing
    or extra keys and ValueError on a shape mismatch or on a buffer whose
    dtype the source does not have, naming the key."""
    params = model.state_dict(keep_vars=True)      # parameters, buffers
    buffers = {k: v for k, v in model.named_buffers() if k in _OPTIONAL}
    exact = {k for k, v in params.items() if not isinstance(v, nn.Parameter)}
    state = {k: v for k, v in state.items()
             if not k.endswith(_SKIPPED_SUFFIX)}
    missing = sorted(k for k in params if k not in state)
    extra = sorted(k for k in state if k not in params and k not in buffers)
    if missing:
        raise KeyError(f"state is missing parameter(s): {missing}")
    if extra:
        raise KeyError(f"state has unexpected key(s): {extra}")
    targets = {**params, **buffers}
    for name, arr in state.items():
        dst = targets[name]
        src = _to_tensor(arr)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape mismatch for {name}: state has "
                             f"{tuple(src.shape)}, model has "
                             f"{tuple(dst.shape)}")
        if name in exact and src.dtype != dst.dtype:
            raise ValueError(f"dtype mismatch for buffer {name}: state has "
                             f"{src.dtype}, model has {dst.dtype}")
    with torch.no_grad():
        for name, arr in state.items():
            dst = targets[name]
            dst.copy_(_to_tensor(arr).to(device=dst.device, dtype=dst.dtype))


def export_numpy_state(model: nn.Module) -> dict:
    """``{name: numpy array}`` of the parameters and persistent buffers;
    bf16 becomes fp32."""
    out = {}
    for name, p in model.state_dict().items():
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.numpy().copy()
    return out


def load_optimizer_state(opt, state: dict) -> None:
    """Fill ``opt.state`` from a numpy copy of the JAX optimizer state.

    ``state["step"]`` is the number of updates taken; each slot
    (``opt.slots``, e.g. ``moment1``/``moment2``) is ``{name: array}`` over
    the optimizer's parameters; ``state["master"]`` (with
    ``multi_precision``) holds an fp32 array or None per parameter. Every
    tensor lands on its parameter's device in fp32. Raises KeyError on a
    missing slot or parameter and ValueError on a shape mismatch."""
    params = opt.params
    new = {"step": int(np.asarray(state["step"]))}
    groups = list(opt.slots) + (["master"] if opt.multi_precision else [])
    for group in groups:
        if group not in state:
            raise KeyError(f"optimizer state has no {group!r}")
        src = state[group]
        missing = sorted(k for k in params if k not in src)
        if missing:
            raise KeyError(f"optimizer state {group!r} is missing "
                           f"{missing}")
        new[group] = {}
        for k, p in params.items():
            if src[k] is None:
                if group != "master":
                    raise KeyError(f"optimizer state {group!r} has None "
                                   f"for {k}")
                new[group][k] = None
                continue
            t = _to_tensor(src[k])
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"shape mismatch for {group}/{k}: state "
                                 f"has {tuple(t.shape)}, parameter has "
                                 f"{tuple(p.shape)}")
            new[group][k] = t.to(device=p.device, dtype=torch.float32)
    opt.state = new


def init_random(model: nn.Module, seed: int) -> None:
    """Seeded random weights, drawn on the model's device."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for module in model.modules():
        reset = getattr(module, "reset_parameters", None)
        if reset is not None:
            reset(gen)

