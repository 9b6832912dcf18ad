"""Continuous-batching generation engine, counterpart of the reference's
``serve/engine.py`` with the same admission, prefill, decode, eviction and
deadline logic.

One engine drives one model replica on the model's device.  It keeps a fixed
set of ``max_batch`` *lanes*; every decode step runs all lanes through one
``decode_step_paged`` call (inactive lanes masked), so requests join and
leave the batch mid-flight at a fixed batch shape:

* **admission** -- a request is admitted when a lane is free *and* its
  worst-case page demand (``ceil((prompt + max_new) / page_size)``) fits in
  the uncommitted page pool.  Pages are committed logically at admission but
  allocated physically on demand (prefill pages up front, one page whenever
  decode crosses a page boundary), so the free list can never run dry
  mid-flight -- the deadlock-free variant of vLLM-style paging.
* **prefill** -- each admitted prompt runs one ``prefill_paged`` call,
  padded to a power-of-two bucket (a bounded set of shapes); its KV is scattered
  straight into the lane's pages and the first output token is sampled from
  the last prompt position.
* **decode** -- one batched greedy step per tick over every active lane,
  each lane at its own length (per-lane RoPE positions and masks).
* **eviction** -- a lane finishing (length budget, EOS, or a blown
  ``deadline_s``) releases its pages back to the free list the same tick,
  and the lane is immediately re-admittable.  Deadline eviction also covers
  requests still queued: they resolve with ``finish_reason="timeout"`` and
  zero tokens instead of waiting forever.

Per-lane computation is independent of batch composition, so the engine
produces token-for-token the same output as one-at-a-time dense decode --
the equivalence property tests pin down, and what makes seeded load-gen
runs reproducible even though batching is timing-dependent.

Token accounting: the engine clock starts *after* warm-up
(:meth:`ServeEngine.run` runs the decode step and every prefill bucket it
will need once, so the kernel build, library set-up and allocator growth fall
outside the window), and every counted token is timestamped inside the
measured window, after the copy of the step's tokens to the host (the one
host sync per step).  The page pool is updated in place.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.serve.kv_cache import PagedCacheConfig, PagedKVCache
from repro_torch.serve.request import GenerationRequest, GenerationResult


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Capacity knobs; defaults suit smoke runs of reduced configs on the CPU."""

    max_batch: int = 8          # lanes = max concurrent sequences
    page_size: int = 16         # tokens per KV page
    n_pages: int = 96           # shared page pool (all lanes, per layer)
    max_blocks: int = 8         # block-table length; max ctx = blocks * page
    min_prefill_bucket: int = 8

    def cache_config(self) -> PagedCacheConfig:
        return PagedCacheConfig(
            n_pages=self.n_pages, page_size=self.page_size,
            max_batch=self.max_batch, max_blocks=self.max_blocks,
        )

    def prefill_bucket(self, n: int) -> int:
        """Smallest power-of-two bucket >= n (bounds the set of shapes)."""
        b = self.min_prefill_bucket
        while b < n:
            b *= 2
        return b


@dataclasses.dataclass
class EngineStats:
    """Counters over the measured window (clock starts after warm-up)."""

    decode_steps: int = 0
    prefills: int = 0
    tokens_generated: int = 0   # every token timestamped inside the window
    timeouts: int = 0           # requests evicted past their deadline_s
    elapsed_s: float = 0.0
    occupancy: list[int] = dataclasses.field(default_factory=list)
    peak_pages_in_use: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def mean_occupancy(self) -> float:
        return float(np.mean(self.occupancy)) if self.occupancy else 0.0


@dataclasses.dataclass
class _Lane:
    request: GenerationRequest
    admitted_s: float
    length: int                 # tokens materialized in the KV cache
    last_token: int             # fed to the next decode step
    tokens: list[int]
    token_times: list[float]
    committed_blocks: int


class ServeEngine:
    """Continuous-batching engine over one ``DecoderLM`` replica."""

    def __init__(self, model, params, config: EngineConfig | None = None):
        self.model = model
        self.params = params
        self.config = config or EngineConfig()
        self.device = model.device
        self.cache = PagedKVCache(model, self.config.cache_config(), self.device)
        self._lanes: list[Optional[_Lane]] = [None] * self.config.max_batch
        self._pending: deque[GenerationRequest] = deque()  # future arrivals
        self._waiting: deque[GenerationRequest] = deque()  # arrived, unadmitted
        self._committed_blocks = 0
        self._t0: Optional[float] = None
        self.stats = EngineStats()
        self.results: list[GenerationResult] = []

    # ------------------------------------------------------------ model steps
    @torch.no_grad()
    def _decode(self, lengths: np.ndarray, tokens: np.ndarray, active: np.ndarray
                ) -> torch.Tensor:
        """One greedy decode step over all lanes -> next token ids (b,), on the
        device (argmax ties go to the first index)."""
        dev = self.device
        logits, _ = self.model.decode_step_paged(
            self.params, self.cache.pages, self.cache.device_block_tables(),
            torch.tensor(lengths, device=dev), torch.tensor(tokens, device=dev),
            torch.tensor(active, device=dev),
        )
        return torch.argmax(logits[:, -1, :], dim=-1)

    @torch.no_grad()
    def _prefill(self, table: torch.Tensor, length: int, tokens: np.ndarray) -> torch.Tensor:
        """Prefill one padded prompt -> the first generated token id, on the
        device."""
        logits, _ = self.model.prefill_paged(
            self.params, self.cache.pages, table, length,
            torch.tensor(tokens, device=self.device),
        )
        return torch.argmax(logits[0, length - 1])

    # ------------------------------------------------------------------ clock
    def now(self) -> float:
        if self._t0 is None:
            raise RuntimeError("clock not started (call run())")
        return time.perf_counter() - self._t0

    # -------------------------------------------------------------- admission
    def submit(self, request: GenerationRequest) -> None:
        cap = self.cache.config.max_context
        if request.worst_case_tokens > cap:
            raise ValueError(
                f"request {request.request_id}: prompt + max_new = "
                f"{request.worst_case_tokens} exceeds max context {cap}"
            )
        need = self.cache.config.blocks_for(request.worst_case_tokens)
        if need > self.config.n_pages:
            raise ValueError(
                f"request {request.request_id}: needs {need} pages, pool has "
                f"{self.config.n_pages} -- it could never be admitted"
            )
        self._pending.append(request)

    def _free_lane(self) -> Optional[int]:
        for i, lane in enumerate(self._lanes):
            if lane is None:
                return i
        return None

    def _can_admit(self, request: GenerationRequest) -> bool:
        need = self.cache.config.blocks_for(request.worst_case_tokens)
        return self._committed_blocks + need <= self.config.n_pages

    def _admit(self, request: GenerationRequest, lane_id: int) -> None:
        """Grant a lane + page commitment, then prefill the prompt."""
        cfg = self.config
        prompt = list(request.prompt)
        admitted = self.now()
        need = self.cache.config.blocks_for(request.worst_case_tokens)
        self._committed_blocks += need
        self.cache.ensure_capacity(lane_id, len(prompt))

        bucket = cfg.prefill_bucket(len(prompt))
        padded = np.zeros((1, bucket), np.int32)
        padded[0, : len(prompt)] = prompt
        first = int(self._prefill(self.cache.lane_table(lane_id), len(prompt), padded))
        t = self.now()
        self.stats.prefills += 1
        self.stats.tokens_generated += 1
        lane = _Lane(
            request=request, admitted_s=admitted, length=len(prompt),
            last_token=first, tokens=[first], token_times=[t],
            committed_blocks=need,
        )
        self._lanes[lane_id] = lane
        if self._is_finished(lane, first):
            self._finish(lane_id, t, reason=self._reason(lane, first))

    def _admit_arrivals(self) -> None:
        now = self.now()
        while self._pending and self._pending[0].arrival_s <= now:
            self._waiting.append(self._pending.popleft())
        while self._waiting:
            lane_id = self._free_lane()
            if lane_id is None or not self._can_admit(self._waiting[0]):
                break
            self._admit(self._waiting.popleft(), lane_id)

    def _evict_timeouts(self) -> None:
        """Evict every past-deadline request with ``reason="timeout"``: an
        active lane gives its pages back to the pool the same tick (and is
        immediately re-admittable); an arrived-but-unadmitted request leaves
        the waiting queue with whatever it has -- nothing."""
        t = self.now()

        def expired(req: GenerationRequest) -> bool:
            return (req.deadline_s is not None
                    and t >= req.arrival_s + req.deadline_s)

        for i, lane in enumerate(self._lanes):
            if lane is not None and expired(lane.request):
                self.stats.timeouts += 1
                self._finish(i, t, reason="timeout")
        kept: deque[GenerationRequest] = deque()
        while self._waiting:
            req = self._waiting.popleft()
            if expired(req):
                self.stats.timeouts += 1
                self.results.append(GenerationResult(
                    request_id=req.request_id, prompt=req.prompt, tokens=[],
                    arrival_s=req.arrival_s, admitted_s=t, finished_s=t,
                    token_times_s=[], finish_reason="timeout",
                ))
            else:
                kept.append(req)
        self._waiting = kept

    # ----------------------------------------------------------------- decode
    @staticmethod
    def _is_finished(lane: _Lane, token: int) -> bool:
        req = lane.request
        return len(lane.tokens) >= req.max_new_tokens or token == req.eos_id

    @staticmethod
    def _reason(lane: _Lane, token: int) -> str:
        return "eos" if token == lane.request.eos_id else "length"

    def _finish(self, lane_id: int, t: float, reason: str) -> None:
        lane = self._lanes[lane_id]
        self.cache.release(lane_id)
        self._committed_blocks -= lane.committed_blocks
        self._lanes[lane_id] = None
        self.results.append(GenerationResult(
            request_id=lane.request.request_id, prompt=lane.request.prompt,
            tokens=lane.tokens, arrival_s=lane.request.arrival_s,
            admitted_s=lane.admitted_s, finished_s=t,
            token_times_s=lane.token_times, finish_reason=reason,
        ))

    def _decode_tick(self) -> None:
        active_ids = [i for i, l in enumerate(self._lanes) if l is not None]
        if not active_ids:
            return
        nb = self.config.max_batch
        tokens = np.zeros((nb, 1), np.int32)
        lengths = np.zeros(nb, np.int32)
        active = np.zeros(nb, bool)
        for i in active_ids:
            lane = self._lanes[i]
            # the incoming token is written at position `length`
            self.cache.ensure_capacity(i, lane.length + 1)
            tokens[i, 0] = lane.last_token
            lengths[i] = lane.length
            active[i] = True
        out = self._decode(lengths, tokens, active).cpu().numpy()
        t = self.now()
        self.stats.decode_steps += 1
        self.stats.occupancy.append(len(active_ids))
        self.stats.peak_pages_in_use = max(
            self.stats.peak_pages_in_use, self.cache.allocator.n_allocated
        )
        for i in active_ids:
            lane = self._lanes[i]
            token = int(out[i])
            lane.length += 1
            lane.last_token = token
            lane.tokens.append(token)
            lane.token_times.append(t)
            self.stats.tokens_generated += 1
            if self._is_finished(lane, token):
                self._finish(i, t, reason=self._reason(lane, token))

    # -------------------------------------------------------------------- run
    def _warmup(self, requests: list[GenerationRequest]) -> None:
        """Run the decode step and every prefill bucket once outside the
        measured window (none of this is counted or timestamped): all lanes
        inactive and an empty block table, so no page is written."""
        nb = self.config.max_batch
        self._decode(np.zeros(nb, np.int32), np.zeros((nb, 1), np.int32), np.zeros(nb, bool))
        empty = torch.full((self.config.max_blocks,), -1, dtype=torch.int32, device=self.device)
        for bucket in sorted({self.config.prefill_bucket(len(r.prompt))
                              for r in requests}):
            self._prefill(empty, 1, np.zeros((1, bucket), np.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, requests: list[GenerationRequest] | None = None,
            ) -> tuple[list[GenerationResult], EngineStats]:
        """Serve ``requests`` (plus anything already submitted) to
        completion; returns (results, stats) and leaves every page free."""
        for r in requests or []:
            self.submit(r)
        queued = sorted(self._pending, key=lambda r: (r.arrival_s, r.request_id))
        self._pending = deque(queued)
        self._warmup(queued)

        self._t0 = time.perf_counter()
        while self._pending or self._waiting or any(self._lanes):
            self._evict_timeouts()  # freed lanes/pages are reusable this tick
            self._admit_arrivals()
            if any(self._lanes):
                self._decode_tick()
            elif self._pending:
                # idle until the next arrival (nothing to batch)
                wait = self._pending[0].arrival_s - self.now()
                if wait > 0:
                    time.sleep(min(wait, 0.01))
        self.stats.elapsed_s = self.now()
        self.results.sort(key=lambda r: r.request_id)
        return self.results, self.stats
