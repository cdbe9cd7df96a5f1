"""Serving metrics (adapted subset of paddle_tpu/serving/metrics.py).

TTFT, inter-token latency (ITL) and time per output token (TPOT) are
taken on the host clock (``time.perf_counter``) when a token is
emitted, which in this engine is after the step's device-to-host copy,
so they include the device work. With the int8 KV pool the engine
also reports the largest absmax scale its prefills wrote
(``kv_quant_scale_max``); half of it bounds every cached element's
dequantization error (``kv_quant_err_bound``, metrics.py:734-738).
"""

from __future__ import annotations

import time

__all__ = ["ServingMetrics", "percentile"]


def percentile(values, p: float) -> float:
    """Linearly-interpolated percentile (numpy's default method); 0.0 on
    empty input."""
    if not values:
        return 0.0
    xs = sorted(values)
    rank = (p / 100.0) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


class ServingMetrics:
    def __init__(self):
        self._arrival: dict[str, float] = {}
        self._first_token: dict[str, float] = {}
        self._last_token: dict[str, float] = {}
        self._n_tokens: dict[str, int] = {}
        self._itl: list[float] = []
        self._admit_t: dict[str, float] = {}
        self._queue_wait: list[float] = []
        self._queue_depth: list[int] = []
        self._pool_util: list[float] = []
        self._finished = 0
        self._preemptions = 0
        self._start: float | None = None
        self._end: float | None = None
        self._prefill_tokens = 0
        self._prefill_cached_tokens = 0
        self._prefix_counters: dict[str, int] = {}
        self.counters: dict[str, int] = {
            "rejected_queue_full": 0, "rejected_too_large": 0,
            "quarantined": 0}
        self.kv_quant_enabled = 0
        self.kv_quant_scale_max = 0.0

    def now(self) -> float:
        return time.perf_counter()

    # ---- request lifecycle ----

    def on_arrival(self, rid: str) -> None:
        t = self.now()
        if self._start is None:
            self._start = t
        self._arrival[rid] = t

    def on_admit(self, rid: str) -> None:
        """First admission only: a re-admission after preemption is not
        a new queue wait."""
        if rid in self._admit_t or rid not in self._arrival:
            return
        t = self.now()
        self._admit_t[rid] = t
        self._queue_wait.append(t - self._arrival[rid])

    def on_token(self, rid: str) -> None:
        t = self.now()
        if rid not in self._first_token:
            self._first_token[rid] = t
        else:
            self._itl.append(t - self._last_token[rid])
        self._last_token[rid] = t
        self._n_tokens[rid] = self._n_tokens.get(rid, 0) + 1
        self._end = t

    def on_finish(self, rid: str) -> None:
        self._finished += 1
        self._end = self.now()

    def on_preemption(self) -> None:
        self._preemptions += 1

    def on_reject(self, kind: str) -> None:
        self.counters[f"rejected_{kind}"] += 1

    def on_quarantine(self) -> None:
        self.counters["quarantined"] += 1

    def on_prefill(self, cached_tokens: int, total_tokens: int) -> None:
        """One admission: ``cached_tokens`` of ``total_tokens`` context
        came from the prefix cache."""
        self._prefill_tokens += total_tokens
        self._prefill_cached_tokens += cached_tokens

    def on_prefix_counters(self, counters: dict) -> None:
        self._prefix_counters = dict(counters)

    def set_kv_quant(self, enabled: bool) -> None:
        """Arm the ``kv_quant_enabled`` gauge (metrics.py:544)."""
        self.kv_quant_enabled = int(bool(enabled))

    def on_kv_quant_scale(self, scale_max: float) -> None:
        """Fold one prefill's largest absmax scale into the running max."""
        self.kv_quant_scale_max = max(self.kv_quant_scale_max,
                                      float(scale_max))

    def on_step(self, queue_depth: int, pool_utilization: float) -> None:
        self._queue_depth.append(queue_depth)
        self._pool_util.append(pool_utilization)

    # ---- aggregation ----

    def ttfts(self) -> list[float]:
        return [self._first_token[r] - self._arrival[r]
                for r in self._first_token if r in self._arrival]

    def tpots(self) -> list[float]:
        return [(self._last_token[r] - self._first_token[r]) / (n - 1)
                for r, n in self._n_tokens.items() if n > 1]

    @property
    def total_tokens(self) -> int:
        return sum(self._n_tokens.values())

    def cache_hit_rate(self) -> float:
        if self._prefill_tokens == 0:
            return 0.0
        return self._prefill_cached_tokens / self._prefill_tokens

    def summary(self) -> dict:
        ttft, tpot = self.ttfts(), self.tpots()
        wall = ((self._end - self._start)
                if self._start is not None and self._end is not None else 0.0)
        return {
            "requests_finished": self._finished,
            "tokens_generated": self.total_tokens,
            "wall_s": wall,
            "tokens_per_s": (self.total_tokens / wall) if wall > 0 else 0.0,
            "ttft_p50_s": percentile(ttft, 50),
            "ttft_p99_s": percentile(ttft, 99),
            "tpot_mean_s": (sum(tpot) / len(tpot)) if tpot else 0.0,
            "itl_p50_s": percentile(self._itl, 50),
            "itl_p99_s": percentile(self._itl, 99),
            "preemptions": self._preemptions,
            "queue_depth_max": max(self._queue_depth, default=0),
            "queue_wait_p50_s": percentile(self._queue_wait, 50),
            "kv_util_peak": max(self._pool_util, default=0.0),
            "cache_hit_rate": self.cache_hit_rate(),
            "prefill_tokens": self._prefill_tokens,
            "prefill_cached_tokens": self._prefill_cached_tokens,
            **{(k if k.startswith("prefix_") else "prefix_" + k): v
               for k, v in self._prefix_counters.items()},
            **self.counters,
            "kv_quant_enabled": self.kv_quant_enabled,
            "kv_quant_scale_max": self.kv_quant_scale_max,
            "kv_quant_err_bound": self.kv_quant_scale_max / 2.0,
        }
