"""The card-side checks' own logic, on the CPU.

``chip_smoke.py`` holds each profiled training step to the flash
forward and backward instantiations of its mode (``check_wgmma_forward``,
``check_fp32_forward``, ``check_fp32_backward``,
``check_wgmma_backward``, from the profiler's
kernel names through ``flash_fwd_kernels`` and ``flash_bwd_kernels``) and
the fp32 MoE step to its grouped forward's and backward's
(``check_fp32_grouped_forward``, ``check_fp32_grouped_backward``,
through ``grouped_kernels``; each split launch goes to its pass by
``grouped_passes``),
and ``chip_mutants.py`` plants each of its
faults by replacing one piece of text of a kernel source, which must
occur there exactly once. The paged kernel's gate sweep
(``paged_sweep_errors``) is rehearsed with the plain version standing in
for the kernel: it must pass it and fail a kernel that is off by 1% or
that does not repeat itself. Both run only on the card; these tests pin
them here, so that a renamed instantiation or an edited source cannot
leave a check that passes every step or a fault that no longer plants.
"""

import importlib.util
import itertools
import types
from pathlib import Path

import pytest
import torch

from torch_one_thread import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "paddle_tpu_torch" / "csrc"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


S = _load("chip_smoke")
M = _load("chip_mutants")

# profiler names of the fp32 backward's instantiations, as CUPTI gives them
_ARGS = "(float const*, float const*, float*, int, int, int, float, int)"


def _names(bias, drop):
    b, d = str(bias).lower(), str(drop).lower()
    return [f"void flash_tf32::{k}_tf32_kernel<{b}, {d}>{_ARGS}"
            for k in ("dq", "dkv")] + ["void layer_norm_fwd_kernel<float>()"]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("drop", [False, True])
def test_fp32_backward_check_takes_its_mode_alone(bias, drop):
    """A step that ran the TF32 kernels of its mode passes; one that ran
    another mode's, or an fp32 mma.sync kernel beside them, fails."""
    S.check_fp32_backward("t", S.flash_bwd_kernels(_names(bias, drop)),
                          drop=drop, bias=bias)
    for other in ((not bias, drop), (bias, not drop)):
        with pytest.raises(AssertionError):
            S.check_fp32_backward("t", S.flash_bwd_kernels(_names(*other)),
                                  drop=drop, bias=bias)
    mma = ("void (anonymous namespace)::flash_bwd_dq_kernel<float, 64, "
           "true, true, false>(float const*)")
    with pytest.raises(AssertionError):
        S.check_fp32_backward(
            "t", S.flash_bwd_kernels(_names(bias, drop) + [mma]), drop=drop,
            bias=bias)


# profiler names of the fp32 TF32 wgmma forward's instantiations
_TF32_FWD_ARGS = ("(float*, float*, int, int, int, float, int, int, "
                  "flash_wg::Mode, CUtensorMap_st, CUtensorMap_st, "
                  "CUtensorMap_st)")


def _tf32_fwd_names(bias, drop):
    b, d = str(bias).lower(), str(drop).lower()
    return [f"void flash_tf32::fwd_tf32_kernel<{b}, {d}>{_TF32_FWD_ARGS}",
            "void layer_norm_fwd_kernel<float>()"]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("drop", [False, True])
def test_fp32_forward_check_takes_its_mode_alone(bias, drop):
    """A step that ran the TF32 forward of its mode (``<HAS_BIAS,
    DROP>``) passes; one that ran another mode's, or an fp32 mma.sync
    ``flash_fwd_kernel`` beside it, fails."""
    def prof(names):
        return {"flash_fwd_kernels": S.flash_fwd_kernels(names)}

    S.check_fp32_forward("t", prof(_tf32_fwd_names(bias, drop)), bias=bias,
                         drop=drop)
    for other in ((not bias, drop), (bias, not drop)):
        with pytest.raises(AssertionError):
            S.check_fp32_forward("t", prof(_tf32_fwd_names(*other)),
                                 bias=bias, drop=drop)
    mma = ("void (anonymous namespace)::flash_fwd_kernel<float, 64, "
           f"{str(bias).lower()}, {str(drop).lower()}, false>"
           "(float const*)")
    with pytest.raises(AssertionError):
        S.check_fp32_forward(
            "t", prof(_tf32_fwd_names(bias, drop) + [mma]), bias=bias,
            drop=drop)


# profiler names of an fp32 MoE step's grouped kernels (forward, dX and
# dW on TF32 wgmma), as CUPTI gives them
_ANON = "void (anonymous namespace)::"
_SPLIT = [f"{_ANON}split_hilo_kernel<{p}>(float const*, float*)"
          for p in ("true", "false")]


def _tf32_names(gated, fwd):
    """Pass 1 and pass 2 of the fp32 forward (``fwd``) or dX of the gated
    kind or not (``gated``), and dW with dX; pass 2 of the forward is the
    ungated instantiation whatever the kind."""
    g, f = str(gated).lower(), str(fwd).lower()
    args = "(float const*, int const*)"
    if fwd:
        return [f"{_ANON}dx_h_tf32_kernel<{g}, true>{args}",
                f"{_ANON}dx_out_tf32_kernel<false, true>{args}"]
    return ([f"{_ANON}{k}_tf32_kernel<{g}, false>{args}"
             for k in ("dx_h", "dx_out")]
            + [f"{_ANON}dw_tf32_kernel<{g}>{args}"])


def _grouped_names(gated, extra=()):
    return (_SPLIT + [f"{_ANON}dgw_reduce_kernel(float const*, float*, int, "
                      "int)"]
            + _tf32_names(gated, True) + _tf32_names(gated, False)
            + [f"{_ANON}{k}" for k in extra])


@pytest.mark.parametrize("gated", [False, True])
def test_fp32_grouped_backward_check_takes_its_kind_alone(gated):
    """The fp32 MoE step's FFN is gated silu. A step whose grouped
    backward ran the TF32 dX pass 1, pass 2 and dW of the gated kind
    passes; one that ran the ungated kind's, in place of them or beside
    them, fails, and so does one that lacked one of them or ran a
    first-design ``expert_h_kernel<true>``, ``dx_out_kernel`` or
    ``dw_kernel``."""
    def prof(names):
        return {"grouped_kernels": S.grouped_kernels(names)}

    if not gated:
        for names in (_grouped_names(False),
                      _grouped_names(True) + _tf32_names(False, False)):
            with pytest.raises(AssertionError):
                S.check_fp32_grouped_backward("t", prof(names))
        return
    S.check_fp32_grouped_backward("t", prof(_grouped_names(True)))
    without_dw = [n for n in _grouped_names(True) if "dw_tf32" not in n]
    with pytest.raises(AssertionError):
        S.check_fp32_grouped_backward("t", prof(without_dw))
    for old in ("expert_h_kernel<true>(float const*)",
                "dx_out_kernel(int const*, float const*)",
                "dw_kernel(float const*, int const*)"):
        with pytest.raises(AssertionError):
            S.check_fp32_grouped_backward(
                "t", prof(_grouped_names(True, [old])))


@pytest.mark.parametrize("gated", [False, True])
def test_fp32_grouped_forward_check_takes_its_kind_alone(gated):
    """A step whose grouped forward ran the TF32 FWD pass 1 of the gated
    kind and the shared pass 2 passes, whatever its backward ran; one that
    ran the ungated pass 1, in place of the gated one or beside it, fails,
    and so does one that lacked pass 2 or ran a first-design
    ``expert_h_kernel`` or ``fwd_out_kernel`` beside them."""
    def prof(names):
        return {"grouped_kernels": S.grouped_kernels(names)}

    if not gated:
        for names in (_grouped_names(False),
                      _grouped_names(True) + _tf32_names(False, True)):
            with pytest.raises(AssertionError):
                S.check_fp32_grouped_forward("t", prof(names))
        return
    S.check_fp32_grouped_forward("t", prof(_grouped_names(True)))
    without_p2 = [n for n in _grouped_names(True)
                  if "dx_out_tf32_kernel<false, true>" not in n]
    with pytest.raises(AssertionError):
        S.check_fp32_grouped_forward("t", prof(without_p2))
    for old in ("expert_h_kernel(float const*, int const*)",
                "fwd_out_kernel(int const*, float const*)"):
        with pytest.raises(AssertionError):
            S.check_fp32_grouped_forward(
                "t", prof(_grouped_names(True, [old])))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_grouped_passes_give_each_split_its_pass(dtype):
    """In launch order (a profiled fp32 step: forward split, pass 1, pass
    2, ..., dX split, dX passes, dgw, dW split x3, dW), each split launch
    goes to the pass of the grouped kernel after it, and kernels of other
    kinds between them change nothing; the bf16 passes need no split."""
    fwd, dx = _tf32_names(True, True), _tf32_names(True, False)
    dgw = f"{_ANON}dgw_reduce_kernel(float const*, float*, int, int)"
    other = "void rms_norm_kernel<float>(float const*)"
    if dtype == "fp32":
        seq = ([_SPLIT[1], other] + fwd + [other, _SPLIT[0]] + dx[:2]
               + [dgw] + [_SPLIT[1]] * 3 + dx[2:])
        want = {"fwd": sorted(S._short_kernel_name(n)
                              for n in [_SPLIT[1]] + fwd),
                "dx": sorted(S._short_kernel_name(n)
                             for n in [_SPLIT[0]] + dx[:2] + [dgw]),
                "dw": sorted(S._short_kernel_name(n)
                             for n in [_SPLIT[1], dx[2]])}
    else:
        names = [f"{_ANON}dx_h_wgmma_kernel<true, true>(bf16 const*)",
                 f"{_ANON}dx_out_wgmma_kernel<false, true>(int const*)",
                 f"{_ANON}dx_h_wgmma_kernel<true, false>(bf16 const*)",
                 f"{_ANON}dx_out_wgmma_kernel<true, false>(int const*)",
                 dgw, f"{_ANON}dw_wgmma_kernel<true>(bf16 const*)"]
        seq = names[:2] + [other] + names[2:]
        short = [S._short_kernel_name(n) for n in names]
        want = {"fwd": sorted(short[:2]), "dx": sorted(short[2:5]),
                "dw": short[5:]}
    assert S.grouped_passes(seq) == want
    assert S.grouped_passes([]) == {}


def test_routing_kernels_named():
    """The routing kernels among a step's names: the tiled kernel, and the
    one-block kernel that a parent tree's step runs
    (``tools/flash_ab.py --tree``)."""
    names = [f"{_ANON}routing_tiles_kernel(float const*, float const*)",
             "void rms_norm_kernel<float>(float const*)",
             f"{_ANON}dx_h_tf32_kernel<true, true>(float const*)"]
    assert S.routing_kernels(names) == ["routing_tiles_kernel"]
    assert S.routing_kernels(names + [f"{_ANON}routing_kernel(float*)"]) \
        == ["routing_kernel", "routing_tiles_kernel"]


@pytest.mark.parametrize("wide", [False, True])
def test_routing_record_routes_near_ties_alike(wide):
    """The fp32 MoE parity's routing record (``_record_routing``), the
    plain run first: a kernel-run row whose top expert differs from the
    plain run's at a margin below ``ROUTE_MARGIN`` is routed on the plain
    run's logits, the plain run keeps its own route, and the record keeps
    the kernel run's own decision, so that ``routing_agreement`` still
    counts it; a row that differs at a wide margin (``wide``) keeps its
    own route and fails the rule."""
    import torch
    from paddle_tpu_torch.distributed import moe as port_moe
    gen = torch.Generator().manual_seed(0)
    plain = torch.randn((64, 8), generator=gen)
    u = torch.rand((64,), generator=gen)
    plain[3, :2] = torch.tensor([2.0, 2.0 + 2e-7])    # a near tie
    kernel = plain.clone()
    kernel[3, 1] = 2.0 - 2e-7                          # decided otherwise
    if wide:
        kernel[7] = -kernel[7]
    orig = port_moe._top2_parts
    calls, mark, undo = S._record_routing(torch, port_moe)
    try:
        mark()
        a = port_moe._top2_parts(plain, 16, u=u)
        mark()
        b = port_moe._top2_parts(kernel, 16, u=u)
    finally:
        undo()
    assert port_moe._top2_parts is orig
    assert a[0][3] == b[0][3] == 1            # the plain run's route
    assert calls[1][2][3] == 0                # the record: its own route
    assert (a[0][7] != b[0][7]) == wide
    route = S.routing_agreement(torch, calls)
    assert route["rows_deciding_otherwise"] == (2 if wide else 1)
    assert route["rows_routed_alike"] == 1
    assert bool(route["failures"]) == wide


# profiler names of the bf16 wgmma forward's instantiations
_FWD_ARGS = ("(__nv_bfloat16*, float*, int, int, int, float, int, int, "
             "flash_wg::Mode, CUtensorMap_st, CUtensorMap_st, "
             "CUtensorMap_st)")


def _fwd_names(d, bias, drop):
    b, p = str(bias).lower(), str(drop).lower()
    return [f"void flash_wg::fwd_wgmma_kernel<{d}, {b}, {p}>{_FWD_ARGS}",
            "void layer_norm_fwd_kernel<__nv_bfloat16>()"]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("drop", [False, True])
def test_wgmma_forward_check_takes_its_mode_alone(d, bias, drop):
    """A step that ran the wgmma forward of its mode (``<D, HAS_BIAS,
    DROP>``) passes; one that ran another mode's, or a bf16 mma.sync
    ``flash_fwd_kernel`` beside it, fails."""
    mode = f"<{d}, {str(bias).lower()}, {str(drop).lower()}>"

    def prof(names):
        return {"flash_fwd_kernels": S.flash_fwd_kernels(names)}

    S.check_wgmma_forward("t", prof(_fwd_names(d, bias, drop)), mode)
    for other in ((192 - d, bias, drop), (d, not bias, drop),
                  (d, bias, not drop)):
        with pytest.raises(AssertionError):
            S.check_wgmma_forward("t", prof(_fwd_names(*other)), mode)
    mma = ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, "
           f"{d}, {str(bias).lower()}, {str(drop).lower()}, false>"
           "(__nv_bfloat16 const*)")
    with pytest.raises(AssertionError):
        S.check_wgmma_forward(
            "t", prof(_fwd_names(d, bias, drop) + [mma]), mode)


@pytest.mark.parametrize("name", sorted(M.MUTANTS))
def test_mutant_plants_once(name):
    """Each planted fault's text occurs exactly once in its source, and
    its replacement differs from it (``chip_mutants._copy`` refuses
    anything else on the card)."""
    for source, old, new in M.MUTANTS[name][1]:
        text = (CSRC / source).read_text()
        assert text.count(old) == 1, (source, old)
        assert new != old


def test_paged_sweep_covers_the_gate():
    """Every q dtype x pool dtype x d x G x page size of the sweep, G 16
    over fp32 pools at d 128, and live lengths on and one past the
    kernel's chunk edges."""
    cases = S.paged_sweep_cases()
    want = set(itertools.product(("float32", "bfloat16"),
                                 ("float32", "bfloat16", "int8"), (32, 64),
                                 (1, 8, 16), (1, 5, 64)))
    assert want <= set(cases)
    assert {("float32", "float32", 128, 16, 16),
            ("bfloat16", "float32", 128, 16, 16)} <= set(cases)
    live = {n + 1 for n in S.SWEEP_LENS if n is not None}
    assert {64, 65, 128, 129} <= live and None in S.SWEEP_LENS


def _plain_kernels(fn):
    from paddle_tpu_torch.ops.kernels import paged_attention_plain
    return types.SimpleNamespace(paged_attention_cuda=fn(
        paged_attention_plain), paged_attention_plain=paged_attention_plain)


@pytest.mark.parametrize("fault", [None, "scaled", "unrepeatable"])
def test_paged_sweep_check_on_cpu(fault, monkeypatch):
    from paddle_tpu_torch import quantization as QZ
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []

    def wrap(plain):
        def run(*a, **k):
            calls.append(1)
            out = plain(*a, **k)
            if fault == "scaled":
                return out * 1.01
            if fault == "unrepeatable" and len(calls) % 2 == 0:
                return out.clone().view(-1).roll(1).view(out.shape)
            return out
        return run
    cases = [c for c in S.paged_sweep_cases() if c[3] in (1, 16)
             and c[2] == 32]
    out = S.paged_sweep_errors(torch, _plain_kernels(wrap), QZ,
                               torch.Generator().manual_seed(0), cases,
                               device="cpu")
    assert out["cases"] == len(cases) + 2
    if fault is None:
        assert out["failures"] == []
    else:
        # every case fails, the dominant-last ones included
        assert len({f.split(":")[0] for f in out["failures"]}) \
            == out["cases"]
        reason = ("outside the tolerance" if fault == "scaled"
                  else "two launches differ")
        assert all(reason in f for f in out["failures"])
