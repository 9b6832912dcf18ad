"""Request/response contract of the serving engine (DESIGN.md §7.2).

Mirrors the scheduler's request/result split (`core/scheduler.py`): a
:class:`GenerationRequest` carries everything the engine needs to produce
tokens, a :class:`GenerationResult` carries everything a benchmark or caller
may want back -- including the per-token completion timestamps the latency
percentiles are computed from.

All timestamps are seconds on the engine's monotonic clock, whose zero is
the start of the *measured window* (after warm-up), so token accounting
and throughput derive from exactly the tokens generated inside that window.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GenerationRequest:
    """One generation call: prompt tokens + decode budget + arrival time."""

    request_id: int
    prompt: tuple[int, ...]
    max_new_tokens: int
    arrival_s: float = 0.0          # offset from load start (Poisson arrivals)
    eos_id: Optional[int] = None    # stop early on this token if set
    deadline_s: Optional[float] = None  # e2e SLO budget from arrival; the
                                        # engine evicts the request (queued or
                                        # mid-decode) once it is exceeded

    def __post_init__(self):
        if not self.prompt:
            raise ValueError(f"request {self.request_id}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.request_id}: max_new_tokens must be >= 1"
            )
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"request {self.request_id}: deadline_s must be positive"
            )

    @property
    def worst_case_tokens(self) -> int:
        """Context size the admission controller must budget pages for."""
        return len(self.prompt) + self.max_new_tokens


@dataclasses.dataclass
class GenerationResult:
    """Outcome of one request, with the full latency trail."""

    request_id: int
    prompt: tuple[int, ...]
    tokens: list[int]               # generated tokens, in order
    arrival_s: float
    admitted_s: float               # prefill started (lane + pages granted);
                                    # eviction time for never-admitted timeouts
    finished_s: float
    token_times_s: list[float] = dataclasses.field(default_factory=list)
    finish_reason: str = "length"   # "length" | "eos" | "timeout"

    @property
    def n_generated(self) -> int:
        return len(self.tokens)

    @property
    def ttft_s(self) -> float:
        """Time to first token, from arrival (queueing + prefill)."""
        return self.token_times_s[0] - self.arrival_s

    @property
    def e2e_s(self) -> float:
        return self.finished_s - self.arrival_s

    def inter_token_s(self) -> list[float]:
        """Gaps between consecutive generated tokens (decode cadence)."""
        t = self.token_times_s
        return [t[i] - t[i - 1] for i in range(1, len(t))]
