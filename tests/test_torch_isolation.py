"""The port stands alone: ``paddle_tpu_torch`` imports neither JAX nor
anything of the JAX package, and its entry points refuse to fall back
to the CPU silently.

The import check runs in a fresh interpreter (this test process has
JAX loaded already) and matches top-level names exactly: the port's own
name starts with the string ``paddle_tpu``.
"""

import ast
import os
import pathlib
import subprocess
import sys

import torch

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "paddle_tpu_torch"


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


_PROBE = r"""
import sys
import paddle_tpu_torch
import torch
from paddle_tpu_torch.models import (LlamaForCausalLM, Qwen2MoeForCausalLM,
                                     llama_tiny, qwen2_moe_tiny)
from paddle_tpu_torch.quantization import quantize_for_serving
from paddle_tpu_torch.serving import ServingEngine
m = LlamaForCausalLM(llama_tiny(), device="cpu", seed=0)
e = ServingEngine(m, num_pages=16, page_size=4, max_slots=2,
                  prefill_chunk=4, device="cpu")
rid = e.add_request([1, 2, 3, 4, 5, 6], 3)
assert len(e.run_to_completion()[rid]) == 3
e = ServingEngine(quantize_for_serving(m), num_pages=16, page_size=4,
                  max_slots=2, prefill_chunk=4, kv_quant=True, device="cpu")
rid = e.add_request([1, 2, 3, 4, 5, 6], 3)
assert len(e.run_to_completion()[rid]) == 3
q = Qwen2MoeForCausalLM(qwen2_moe_tiny(ep_dispatch="fused"), device="cpu")
ids = torch.arange(32).reshape(2, 16)
q.loss(q(ids), ids).backward()
print("\n".join(sorted(sys.modules)))
"""


def test_port_imports_no_jax_in_a_fresh_interpreter():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = out.stdout.split()
    assert "paddle_tpu_torch.serving.engine" in mods
    assert "paddle_tpu_torch.quantization.serving" in mods
    assert "paddle_tpu_torch.ops.kernels.moe_grouped_gemm" in mods
    bad = [m for m in mods if _banned(m)]
    assert not bad, bad


def test_no_source_file_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _banned(n)]
            assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_entry_points_raise_without_a_device_argument_or_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid")
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         Qwen2MoeForCausalLM, llama_tiny,
                                         qwen2_moe_tiny)
    from paddle_tpu_torch.serving import ServingEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(llama_tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Qwen2MoeForCausalLM(qwen2_moe_tiny())
    model = LlamaForCausalLM(llama_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, num_pages=8, page_size=4)
