"""Build the port's CUDA kernels from the repository's sources.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``. Libraries land in
``build/kernels/`` at the repository root (git-ignored), named by a
hash of their source and the shared ``csrc/*.cuh`` headers, so an
edited source rebuilds and an unchanged one is reused. ``build_all`` starts one ``nvcc`` per source at once and
waits for all of them; ``library`` builds one on first use.

Nothing here runs at import time: the CPU tests import every module,
and ``nvcc`` is needed only when a kernel is first launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "library", "ptxas_report"]

_PKG = Path(__file__).resolve().parents[2]
SOURCES = {
    "rms_norm": _PKG / "csrc" / "rms_norm.cu",
    "paged_attention": _PKG / "csrc" / "paged_attention.cu",
    "flash_attention_fwd": _PKG / "csrc" / "flash_attention_fwd.cu",
    "flash_attention_bwd": _PKG / "csrc" / "flash_attention_bwd.cu",
    "moe_routing": _PKG / "csrc" / "moe_routing.cu",
    "moe_grouped_gemm": _PKG / "csrc" / "moe_grouped_gemm.cu",
    "layer_norm": _PKG / "csrc" / "layer_norm.cu",
}
# headers the sources include; a change to one rebuilds every source
HEADERS = sorted((_PKG / "csrc").glob("*.cuh"))
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (checked PATH and $CUDA_HOME/bin); "
                       "the CUDA toolkit is needed to build the kernels")


def _target(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in HEADERS:
        h.update(header.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None) -> dict[str, dict]:
    """Build the named kernels (default: all), one ``nvcc`` per source,
    all started together. Returns ``{name: {"path", "built", "log"}}``
    where ``log`` holds ``-Xptxas -v``'s register/shared-memory report.
    Raises RuntimeError with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = {"path": target, "built": False, "log": ""}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, target)
        out[name] = {"path": target, "built": True, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def ptxas_report(log: str) -> dict[str, str]:
    """``-Xptxas -v``'s report of a build log, one line per kernel
    instantiation (its mangled name): registers and spilled bytes."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function '" in line:
            fn = line.split("'")[1]
        elif fn and "spill stores" in line:
            out[fn] = line.strip()
        elif fn and "Used " in line and " registers" in line:
            regs = line.split("Used ")[1].split(" registers")[0]
            out[fn] = f"{regs} registers; {out.get(fn, '')}"
            fn = None
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[name]["path"]
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
