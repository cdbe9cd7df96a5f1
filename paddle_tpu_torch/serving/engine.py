"""Continuous-batching serving engine over the paged KV pool
(counterpart: paddle_tpu/serving/engine.py:136).

Two step shapes, as in the JAX engine:

- the DECODE step ``[max_slots]`` (engine.py:1470, 1854): one token per
  running slot; its attention is the paged decode kernel on the card;
- the MIXED step ``[max_slots, chunk]`` (engine.py:1524, 1899): each
  slot carries ``(start_pos, n_new)`` as the ``seq_lens``/``n_live``
  lanes and processes either a prefill chunk (``forced`` lane set: its
  rows are teacher-forced prompt tokens and all are accepted,
  ``m = n_live - 1``) or its one decode row. Rows beyond ``n_live`` and
  inactive slots write scratch page 0; rejected live rows are zeroed in
  the step. A step with any prefill chunk takes this shape, a pure
  decode step the decode shape.

The host builds every lane (tables, ``seq_lens``, active, ``n_live``,
forced, tokens) as numpy in ONE flat int32 buffer of fixed size per step
shape, copied to the device once per step; tokens and the per-slot
finite flag come back in one copy. Shapes never change with the traffic,
so a later change can capture each step shape in a CUDA graph.

``kv_quant=True`` (or ``kv_dtype="int8"``) makes the pool int8: the
model quantizes each row as it writes it, the decode step's kernel runs
in its int8 mode, the mixed step's core dequantizes to fp32, and the
metrics carry the largest scale the prefills wrote (engine.py:188-205,
1742-1748, 2030-2034). A model from ``quantize_for_serving`` streams
int8 weights through the same engine unchanged.

Greedy decoding only: a request with ``SamplingParams(do_sample=True)``
raises NotImplementedError (the JAX engine's sampled streams need its
threefry key stream, not ported yet). Not ported: LoRA, tensor and
pipeline parallelism, speculative decoding, the unchunked prefill path,
the host tier, snapshots, brownout, fair scheduling, deadlines, drain,
fault injection and the watchdog.

Every model call runs under ``torch.no_grad()``; the pool tensors are
updated in place.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..core import resolve_device
from .errors import (QueueFullError, RequestTooLargeError,
                     SchedulerStalledError)
from .kv_cache import KVCachePool
from .metrics import ServingMetrics
from .scheduler import Request, SamplingParams, Scheduler

__all__ = ["ServingEngine"]

# consecutive zero-progress steps tolerated before SchedulerStalledError
_STALL_PATIENCE = 3
# prefill-chunk tokens one step may carry (the JAX engine's default)
_PREFILL_TOKEN_BUDGET = 2048


class ServingEngine:
    def __init__(self, model, num_pages: int, page_size: int,
                 max_slots: int = 4, max_pages_per_slot: int | None = None,
                 max_queue_depth: int | None = None, prefill_chunk: int = 64,
                 kv_quant: bool = False, kv_dtype=None, device=None):
        """``device=None`` means the GPU (RuntimeError without one); the
        model must already live on the engine's device. The KV pool is
        bf16 with prefix caching on, the JAX engine's defaults, or int8
        with ``kv_quant=True``; ``kv_dtype="int8"`` (or ``torch.int8``)
        is an alias for it, and ``kv_dtype`` takes no other value but
        bf16 (the port's only fp pool)."""
        if kv_dtype is not None:
            name = str(kv_dtype).replace("torch.", "")
            if name == "int8":
                kv_quant = True
            elif name != "bfloat16":
                raise ValueError(f"kv_dtype must be None, 'bfloat16' or "
                                 f"'int8'; got {kv_dtype!r}")
        dev = resolve_device(device)
        if dev.type != model.device.type or (dev.index is not None
                                             and dev != model.device):
            raise ValueError(f"model is on {model.device}, engine asked "
                             f"for {dev}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        cfg = model.config
        self.model = model
        self.device = model.device
        self.page_size = page_size
        self.max_slots = max_slots
        self.max_pages_per_slot = (max_pages_per_slot
                                   if max_pages_per_slot is not None
                                   else num_pages - 1)
        self.prefill_chunk = int(prefill_chunk)
        self.kv_quant = bool(kv_quant)
        self.pool = KVCachePool.from_config(cfg, num_pages, page_size,
                                            device=self.device,
                                            quantized=self.kv_quant)
        # every (re-)admission must fit the slot's table and the rope table
        self._ctx_pages = min(self.max_pages_per_slot,
                              self.pool.pages_for(cfg.max_position_embeddings))
        self.scheduler = Scheduler(max_slots, max_queue_depth)
        self.metrics = ServingMetrics()
        self.metrics.set_kv_quant(self.kv_quant)
        self._requests: dict[str, Request] = {}
        self._rid_counter = itertools.count()
        self._steps = 0
        self._idle_steps = 0
        # model dispatches per step shape
        self.step_counts = {"decode": 0, "mixed": 0}

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def add_request(self, prompt, max_new_tokens: int,
                    sampling: SamplingParams | None = None,
                    eos_token_id: int | None = None,
                    rid: str | None = None) -> str:
        """Queue a request; returns its id. Raises RequestTooLargeError
        for a request that can never run here, QueueFullError when the
        bounded queue is full, NotImplementedError for sampling."""
        sampling = sampling or SamplingParams()
        if sampling.do_sample:
            raise NotImplementedError(
                "sampled decoding is not ported yet; only greedy requests "
                "are served (ROADMAP.md: 'threefry-exact top-p sampling')")
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("prompt must be non-empty")
        try:
            self.admission_check(len(prompt), max_new_tokens)
        except RequestTooLargeError:
            self.metrics.on_reject("too_large")
            raise
        rid = rid if rid is not None else f"req-{next(self._rid_counter)}"
        old = self._requests.get(rid)
        if old is not None and not old.done:
            raise ValueError(f"duplicate request id {rid!r}")
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      sampling=sampling, eos_token_id=eos_token_id)
        try:
            self.scheduler.add(req, self.pool)
        except QueueFullError:
            self.metrics.on_reject("queue_full")
            raise
        except RequestTooLargeError:
            self.metrics.on_reject("too_large")
            raise
        self._requests[rid] = req
        self.metrics.on_arrival(rid)
        return rid

    def admission_check(self, prompt_len: int, max_new_tokens: int) -> None:
        """Raise RequestTooLargeError if a request of this geometry can
        never run here (engine.py:483)."""
        total = prompt_len + max_new_tokens
        need = self.pool.pages_for(total)
        if need > self.max_pages_per_slot:
            raise RequestTooLargeError(
                f"request needs {need} pages (max_pages_per_slot="
                f"{self.max_pages_per_slot})")
        ctx = self._ctx_pages * self.page_size
        if total - 1 > ctx:
            raise RequestTooLargeError(
                f"request context ({total} tokens) exceeds the context "
                f"window of {ctx} tokens")

    def request(self, rid: str) -> Request:
        return self._requests[rid]

    def step(self) -> list[dict]:
        """One scheduling iteration (engine.py:596): admit, guarantee
        decode pages (preempting if needed), then one dispatch over the
        running slots. Returns this step's token/finish events. Raises
        SchedulerStalledError after repeated zero-progress steps."""
        if not self.scheduler.has_work():
            return []
        events: list[dict] = []
        for req in self.scheduler.admit(self.pool):
            self.metrics.on_admit(req.rid)
            self.metrics.on_prefill(req.cached_len, req.prefill_target)
        for _ in self.scheduler.ensure_decode_pages(self.pool):
            self.metrics.on_preemption()
        chunk_tokens = 0
        if self.scheduler.running:
            chunk_tokens = self._run_batch(events)
        self.metrics.on_prefix_counters(self.pool.counters)
        self.metrics.on_step(self.scheduler.queue_depth,
                             self.pool.utilization())
        self._steps += 1
        if events or chunk_tokens or not self.scheduler.waiting:
            self._idle_steps = 0
        else:
            self._idle_steps += 1
            if self._idle_steps >= _STALL_PATIENCE:
                head = self.scheduler.waiting[0]
                snapshot = {
                    "step": self._steps, "idle_steps": self._idle_steps,
                    "queue_depth": self.scheduler.queue_depth,
                    "head_rid": head.rid,
                    "head_needs_pages": self.pool.pages_for(
                        max(head.recompute_len, 1)),
                    "free_pages": self.pool.num_free,
                    "capacity": self.pool.capacity,
                    "running": len(self.scheduler.running)}
                raise SchedulerStalledError(
                    f"{self._idle_steps} zero-progress steps with "
                    f"{snapshot['queue_depth']} request(s) pending: head "
                    f"{head.rid!r} needs {snapshot['head_needs_pages']} "
                    f"pages, {snapshot['free_pages']} free", snapshot)
        return events

    def run_to_completion(self, max_steps: int | None = None) -> dict:
        """Drain the queue; returns ``{rid: generated tokens}``."""
        steps = 0
        while self.scheduler.has_work():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(f"engine did not drain in {steps} steps")
        return {rid: list(r.tokens) for rid, r in self._requests.items()}

    def stats(self) -> dict:
        """Engine state (a subset of engine.py:1227's keys)."""
        return {"steps": self._steps, "pool": self.pool.stats(),
                "queue_depth": self.scheduler.queue_depth,
                "running": len(self.scheduler.running),
                "preemptions": self.scheduler.num_preemptions,
                "step_counts": dict(self.step_counts),
                "kv_quant": self.kv_quant,
                "prefill_chunk": self.prefill_chunk}

    def audit_pool(self) -> dict:
        """The pool's invariant audit against the live block tables."""
        return self.pool.audit(block_tables=[
            list(r.pages) for r in self.scheduler.running.values()
            if r.pages])

    @torch.no_grad()
    def decode_logits(self) -> torch.Tensor:
        """The decode step's ``[max_slots, vocab]`` logits for the current
        running set, without sampling or advancing any request. It writes
        this step's K/V at each slot's ``context_len``, which the next
        real step writes again. For holding the kernels against their
        plain versions on one engine state (``chip_smoke.py``)."""
        if any(r.prefilling for r in self.scheduler.running.values()):
            raise RuntimeError("decode_logits needs every running request "
                               "past its prefill")
        return self._decode_forward(self._upload(self._decode_lanes()))

    # ------------------------------------------------------------------
    # per-step work
    # ------------------------------------------------------------------

    def _upload(self, buf: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(buf).to(self.device)

    def _plan_chunks(self) -> dict[int, int]:
        """slot -> n_new (engine.py:1791): this step's prefill chunks,
        FCFS over the prefilling slots under the token budget; the
        oldest prefilling slot always advances at least one token."""
        budget = _PREFILL_TOKEN_BUDGET
        plan: dict[int, int] = {}
        prefilling = sorted(
            ((slot, req) for slot, req in self.scheduler.running.items()
             if req.prefilling), key=lambda sr: sr[1].arrival_seq)
        for slot, req in prefilling:
            need = req.prefill_target - req.context_len
            cap = budget if plan else max(budget, 1)
            n = min(self.prefill_chunk, need, cap)
            if n <= 0:
                break
            plan[slot] = n
            budget -= n
        return plan

    def _run_batch(self, events: list[dict]) -> int:
        """Any prefill chunk takes the mixed step; a pure-decode step
        the decode step (engine.py:1826). Returns the chunk tokens
        dispatched (progress for the stall detector)."""
        plan = self._plan_chunks()
        if plan:
            return self._run_mixed(events, plan)
        self._run_decode(events)
        return 0

    def _decode_lanes(self) -> np.ndarray:
        """Flat int32 lanes of the decode step:
        ``tables [S*M] | tok [S] | seq_lens [S] | active [S]``."""
        S, M = self.max_slots, self.max_pages_per_slot
        buf = np.zeros(S * M + 3 * S, np.int32)
        tables = buf[:S * M].reshape(S, M)
        tok, seq_lens, active = buf[S * M:].reshape(3, S)
        for slot, req in self.scheduler.running.items():
            tables[slot, :len(req.pages)] = req.pages
            tok[slot] = req.tokens[-1]
            seq_lens[slot] = req.context_len
            active[slot] = 1
        return buf

    def _decode_forward(self, lanes: torch.Tensor) -> torch.Tensor:
        S, M = self.max_slots, self.max_pages_per_slot
        tables = lanes[:S * M].view(S, M)
        tok, seq_lens, active = lanes[S * M:].view(3, S)
        logits, _ = self.model(tok[:, None], self.pool.pools,
                               (tables, seq_lens, active.bool()))
        return logits[:, -1]

    @torch.no_grad()
    def _run_decode(self, events: list[dict]) -> None:
        last = self._decode_forward(self._upload(self._decode_lanes()))
        # per-slot poison sentinel: a non-finite row indicts one slot
        ok = torch.isfinite(last).all(dim=-1)
        out = torch.stack([last.argmax(dim=-1).int(), ok.int()]).cpu()
        nt, ok = out.numpy()
        self.step_counts["decode"] += 1
        for slot, req in list(self.scheduler.running.items()):
            req.context_len += 1  # this step wrote at the old context_len
            if not ok[slot]:
                self._finish_abnormal(req, "nonfinite", events)
                continue
            self._emit(req, int(nt[slot]), events)

    @torch.no_grad()
    def _run_mixed(self, events: list[dict], plan: dict[int, int]) -> int:
        """One mixed dispatch (engine.py:1899): the planned prefill chunks
        and every decoding slot share the ``[max_slots, chunk]`` shape.
        Chunk slots emit only on their final chunk, which is also when
        the prompt's full pages join the prefix index."""
        sched = self.scheduler
        S, M, K = self.max_slots, self.max_pages_per_slot, self.prefill_chunk
        buf = np.zeros(S * K + S * M + 4 * S, np.int32)
        toks = buf[:S * K].reshape(S, K)
        tables = buf[S * K:S * K + S * M].reshape(S, M)
        seq_lens, active, n_live, forced = buf[S * K + S * M:].reshape(4, S)
        decoding: list[int] = []
        chunk_tokens = 0
        for slot, req in sched.running.items():
            if req.prefilling and slot not in plan:
                continue  # out of budget this step: the slot sits out
            tables[slot, :len(req.pages)] = req.pages
            seq_lens[slot] = req.context_len
            active[slot] = 1
            if slot in plan:
                n = plan[slot]
                seq = req.prompt + req.tokens[:-1]
                toks[slot, :n] = seq[req.context_len:req.context_len + n]
                n_live[slot] = n
                forced[slot] = 1
                chunk_tokens += n
            else:
                toks[slot, 0] = req.tokens[-1]
                n_live[slot] = 1
                decoding.append(slot)
        samp, acc, ok = self._mixed_step(self._upload(buf))
        self.step_counts["mixed"] += 1
        for slot in list(plan) + decoding:
            req = sched.running.get(slot)
            if req is None:
                continue
            if slot in plan:
                n = plan[slot]
                req.context_len += n
                if not ok[slot]:
                    self._finish_abnormal(req, "nonfinite", events)
                    continue
                if req.prefilling:
                    continue  # more chunks owed
                # final chunk: the prompt's full pages join the index
                seq = req.prompt + req.tokens[:-1]
                self.pool.register_prefix(seq[:req.prefill_target],
                                          req.pages, include_partial=False)
                if self.kv_quant:
                    self.metrics.on_kv_quant_scale(
                        self._qscale_max(req.pages))
                if req.tokens:
                    continue  # recompute after preemption: no new token
                self._emit(req, int(samp[slot, n - 1]), events)
            else:
                C0 = req.context_len
                if not ok[slot]:
                    req.context_len += 1
                    self._finish_abnormal(req, "nonfinite", events)
                    continue
                m = int(acc[slot])
                emit: list[int] = []
                for j in range(m + 1):
                    t = int(samp[slot, j])
                    emit.append(t)
                    if ((req.eos_token_id is not None
                         and t == req.eos_token_id)
                            or len(req.tokens) + len(emit)
                            >= req.max_new_tokens):
                        break
                req.context_len = C0 + len(emit)
                if len(emit) < m + 1:
                    # accepted rows past an in-window stop go back to zero
                    self.pool.rewind(req.pages, C0 + len(emit), C0 + m + 1)
                for t in emit:
                    self._emit(req, t, events)
        return chunk_tokens

    def _mixed_step(self, lanes: torch.Tensor):
        """The ``[max_slots, chunk]`` forward plus its in-step epilogue
        (engine.py:1558): greedy samples for every row, the accepted
        count ``m`` (all rows of a forced slot; the longest matching
        prefix otherwise), the per-slot finite flag over live rows, and
        the zeroing of rejected live rows at their (page, offset) — all
        other rows target scratch (0, 0)."""
        S, M, K = self.max_slots, self.max_pages_per_slot, self.prefill_chunk
        ps = self.page_size
        toks = lanes[:S * K].view(S, K)
        tables = lanes[S * K:S * K + S * M].view(S, M)
        seq_lens, active, n_live, forced = lanes[S * K + S * M:].view(4, S)
        active, forced = active.bool(), forced.bool()
        logits, pools = self.model(toks, self.pool.pools,
                                   (tables, seq_lens, active, n_live))
        rows = torch.arange(K, device=lanes.device)
        live = rows[None, :] < n_live[:, None]                    # [S, K]
        ok = (torch.isfinite(logits).all(dim=-1) | ~live).all(dim=-1)
        samp = logits.argmax(dim=-1)                              # [S, K]
        match = (toks[:, 1:] == samp[:, :-1]) & live[:, 1:]
        m = torch.cumprod(match.long(), dim=1).sum(dim=1)
        m = torch.where(forced, n_live.long() - 1, m)
        pos = seq_lens.long()[:, None] + rows[None, :]
        rej = live & (rows[None, :] > m[:, None]) & active[:, None]
        page = tables.long().gather(1, (pos // ps).clamp(max=M - 1))
        page = torch.where(rej, page, 0)
        off = torch.where(rej, pos % ps, 0)
        for pk, pv in pools:
            KVCachePool._pos_zero(pk, page, off)
            KVCachePool._pos_zero(pv, page, off)
        out = torch.cat([samp, m[:, None], ok.long()[:, None]], dim=1)
        out = out.int().cpu().numpy()
        return out[:, :K], out[:, K], out[:, K + 1]

    def _qscale_max(self, pages: list[int]) -> float:
        """The largest absmax scale over ``pages`` in every layer's K and
        V (engine.py:1780): per-element dequantization error is at most
        half of it. One device-to-host copy."""
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        return torch.stack([arr.scale[idx].amax()
                            for pair in self.pool.pools
                            for arr in pair]).amax().item()

    def _finish_abnormal(self, req: Request, reason: str,
                         events: list[dict]) -> None:
        """Non-finite logits: the request's pages leave the prefix index
        now and are zeroed when the last holder lets go; only this slot
        finishes."""
        self.pool.quarantine(req.pages)
        self.scheduler.finish(req, self.pool, reason)
        self.metrics.on_quarantine()
        self.metrics.on_finish(req.rid)
        events.append({"rid": req.rid, "token": None, "finished": True,
                       "finish_reason": reason})

    def _emit(self, req: Request, token: int, events: list[dict]) -> None:
        req.tokens.append(token)
        self.metrics.on_token(req.rid)
        reason = None
        if req.eos_token_id is not None and token == req.eos_token_id:
            reason = "stop"
        elif len(req.tokens) >= req.max_new_tokens:
            reason = "length"
        if reason is not None:
            self.scheduler.finish(req, self.pool, reason)
            self.metrics.on_finish(req.rid)
        events.append({"rid": req.rid, "token": token,
                       "finished": reason is not None,
                       "finish_reason": reason})
