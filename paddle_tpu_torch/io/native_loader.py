"""Native (C++) input-pipeline fast path (counterpart:
``paddle_tpu/io/native_loader.py``).

Two memcpy-bound host loops live in C++, built with ``g++`` on first use
and loaded with ``ctypes``:

- :func:`pack_sequences`: greedy sequential packing of variable-length
  token sequences into fixed-length rows, with each row's segment
  starts (``cu_seqlens``, ``-1`` padded): the packed-pretraining input
  format of ``flash_attn_unpadded``;
- :func:`gather_rows`: threaded gather of sample rows from a flat token
  corpus into a batch buffer.

The C++ source is this module's own copy of the JAX package's (the port
imports nothing of it). The library lands in ``build/native/`` at the
repository root (git-ignored), beside the CUDA kernels of
``ops/kernels/build.py``, named by a hash of its source and flags, so
an edited source rebuilds and an unchanged one is reused; a build goes
to a per-process temporary file that is renamed into place, so
processes that build at once never load a partial library. Without a
compiler the numpy fallbacks keep the API working, with the same greedy
algorithm and the same outputs; :func:`native_available` reports which
path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["pack_sequences", "gather_rows", "native_available", "BUILD_DIR"]

_SRC = r"""
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Greedy sequential packing: walk sequences in order, start a new row when
// the current one cannot fit the next sequence (or row seq budget is hit).
// lengths[n] -> rows of width row_len filled with concatenated sequences,
// padded with pad_id. Emits per-row segment starts (cu_seqlens layout:
// row-major, -1 terminated). Returns number of rows produced.
int64_t pack_sequences(const int32_t* tokens, const int64_t* offsets,
                       int64_t n_seqs, int64_t row_len, int32_t pad_id,
                       int32_t* out_rows, int64_t max_rows,
                       int64_t* out_cu, int64_t max_cu_per_row) {
  int64_t row = 0;
  int64_t col = 0;
  int64_t cu_idx = 0;
  // init first row
  for (int64_t j = 0; j < row_len; ++j) out_rows[j] = pad_id;
  for (int64_t c = 0; c < max_cu_per_row; ++c) out_cu[c] = -1;
  out_cu[0] = 0; cu_idx = 1;
  for (int64_t s = 0; s < n_seqs; ++s) {
    const int64_t len = offsets[s + 1] - offsets[s];
    if (len > row_len) continue;  // skip oversize (caller pre-truncates)
    if (col + len > row_len || cu_idx >= max_cu_per_row) {
      // close row, start next
      ++row;
      if (row >= max_rows) return -1;
      col = 0;
      cu_idx = 1;
      int32_t* r = out_rows + row * row_len;
      for (int64_t j = 0; j < row_len; ++j) r[j] = pad_id;
      int64_t* cu = out_cu + row * max_cu_per_row;
      for (int64_t c = 0; c < max_cu_per_row; ++c) cu[c] = -1;
      cu[0] = 0;
    }
    std::memcpy(out_rows + row * row_len + col, tokens + offsets[s],
                sizeof(int32_t) * len);
    col += len;
    out_cu[row * max_cu_per_row + cu_idx] = col;
    ++cu_idx;
  }
  return row + 1;
}

// Threaded gather: out[i] = corpus[idx[i]*row_len : (idx[i]+1)*row_len]
void gather_rows(const int32_t* corpus, const int64_t* idx, int64_t n,
                 int64_t row_len, int32_t* out, int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int64_t t) {
    for (int64_t i = t; i < n; i += n_threads) {
      std::memcpy(out + i * row_len, corpus + idx[i] * row_len,
                  sizeof(int32_t) * row_len);
    }
  };
  if (n_threads == 1) { work(0); return; }
  std::vector<std::thread> ts;
  for (int64_t t = 0; t < n_threads; ++t) ts.emplace_back(work, t);
  for (auto& th : ts) th.join();
}

}  // extern "C"
"""

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_LIB = None
_TRIED = False


def _build() -> Path:
    """The library built from ``_SRC`` (reused when already built)."""
    digest = hashlib.sha256((_SRC + " ".join(_FLAGS)).encode()) \
        .hexdigest()[:16]
    target = BUILD_DIR / f"libpt_fastloader-{digest}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"pt_fastloader-{digest}.{os.getpid()}.cc"
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    src.write_text(_SRC)
    try:
        subprocess.run(["g++", *_FLAGS, str(src), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, target)
    finally:
        src.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return target


def _lib():
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(_build()))
            lib.pack_sequences.restype = ctypes.c_int64
            lib.pack_sequences.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
            lib.gather_rows.restype = None
            lib.gather_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
            _LIB = lib
        except (OSError, subprocess.SubprocessError):
            _LIB = None
    return _LIB


def native_available() -> bool:
    """True when the C++ library built and loaded (else the numpy
    fallbacks run)."""
    return _lib() is not None


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def pack_sequences(seqs, row_len: int, pad_id: int = 0,
                   max_segments_per_row: int = 64, force_numpy: bool = False):
    """Pack variable-length sequences into ``[rows, row_len]`` int32 rows
    plus per-row ``cu_seqlens`` (int64 ``[rows, max_segments_per_row]``,
    ``-1`` padded). Empty sequences are dropped, longer ones cut to
    ``row_len``. Returns ``(rows, cu)``."""
    keep = [np.asarray(s[:row_len], np.int32) for s in seqs
            if 0 < len(s)]
    if not keep:
        return (np.full((0, row_len), pad_id, np.int32),
                np.full((0, max_segments_per_row), -1, np.int64))
    tokens = np.concatenate(keep).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum([len(s) for s in keep])]) \
        .astype(np.int64)
    n = len(keep)
    max_rows = n  # worst case: one row per sequence
    lib = None if force_numpy else _lib()
    if lib is not None:
        rows = np.empty((max_rows, row_len), np.int32)
        cu = np.empty((max_rows, max_segments_per_row), np.int64)
        n_rows = lib.pack_sequences(_ptr(tokens), _ptr(offsets), n, row_len,
                                    pad_id, _ptr(rows), max_rows, _ptr(cu),
                                    max_segments_per_row)
        if n_rows >= 0:
            return rows[:n_rows], cu[:n_rows]
    # numpy fallback — same greedy algorithm
    rows_l, cus, cur, cu_row = [], [], [], [0]
    col = 0
    for s in keep:
        if col + len(s) > row_len or len(cu_row) >= max_segments_per_row:
            pad = np.full(row_len - col, pad_id, np.int32)
            rows_l.append(np.concatenate(cur + [pad]) if cur else pad)
            cus.append(cu_row)
            cur, col, cu_row = [], 0, [0]
        cur.append(s)
        col += len(s)
        cu_row.append(col)
    pad = np.full(row_len - col, pad_id, np.int32)
    rows_l.append(np.concatenate(cur + [pad]) if cur else pad)
    cus.append(cu_row)
    out_cu = np.full((len(rows_l), max_segments_per_row), -1, np.int64)
    for i, c in enumerate(cus):
        out_cu[i, :len(c)] = c
    return np.stack(rows_l), out_cu


def gather_rows(corpus, idx, row_len: int, n_threads: int = 4,
                force_numpy: bool = False):
    """Gather ``[len(idx), row_len]`` token rows from a flat int32 corpus;
    an index outside the corpus raises IndexError."""
    corpus = np.ascontiguousarray(corpus, np.int32).reshape(-1)
    idx = np.ascontiguousarray(idx, np.int64)
    n_rows = corpus.size // row_len
    if idx.size and (idx.min() < 0 or idx.max() >= n_rows):
        raise IndexError(f"row index out of range [0, {n_rows}) "
                         f"(got {int(idx.min())}..{int(idx.max())})")
    lib = None if force_numpy else _lib()
    if lib is not None:
        out = np.empty((len(idx), row_len), np.int32)
        lib.gather_rows(_ptr(corpus), _ptr(idx), len(idx), row_len,
                        _ptr(out), n_threads)
        return out
    c2 = corpus.reshape(-1, row_len) if corpus.size % row_len == 0 else None
    if c2 is not None:
        return c2[idx]
    return np.stack([corpus[i * row_len:(i + 1) * row_len] for i in idx])
