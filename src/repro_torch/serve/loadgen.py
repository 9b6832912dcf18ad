"""Seeded load generator + serving benchmark report (the port's own copy of
the reference's ``serve/loadgen.py``; same seed -> the same request list).

Workloads are fully determined by a :class:`LoadGenConfig` seed: request
arrivals are a Poisson process (exponential inter-arrival gaps at
``rate_rps``), and prompt/response lengths are drawn from discrete
*mixtures* (the short-chat / long-doc mixes real serving traces show).
Because the engine's output is batching-invariant, the *tokens* of a seeded
run are reproducible across machines; only the wall-clock latencies differ.

:func:`run_benchmark` drives an engine over a generated workload and
distills a :class:`ServeReport`: tokens/sec over the measured window,
goodput (completed-request tokens/sec), TTFT and per-token p50/p99, e2e
latency, and batch occupancy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.engine import EngineStats, ServeEngine
from repro_torch.serve.request import GenerationRequest, GenerationResult


@dataclasses.dataclass(frozen=True)
class LengthMixture:
    """Discrete length distribution: ((length, weight), ...)."""

    components: tuple[tuple[int, float], ...]

    def __post_init__(self):
        if not self.components:
            raise ValueError("mixture needs at least one component")
        if any(n < 1 or w < 0 for n, w in self.components):
            raise ValueError(f"bad mixture {self.components}")

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        lengths = np.array([n for n, _ in self.components])
        w = np.array([w for _, w in self.components], dtype=float)
        return rng.choice(lengths, size=size, p=w / w.sum())

    @property
    def max_length(self) -> int:
        return max(n for n, _ in self.components)


# short-chat-heavy defaults, sized for reduced configs on the CPU
DEFAULT_PROMPT_MIX = LengthMixture(((4, 0.5), (8, 0.3), (16, 0.2)))
DEFAULT_RESPONSE_MIX = LengthMixture(((8, 0.5), (16, 0.35), (32, 0.15)))


@dataclasses.dataclass(frozen=True)
class LoadGenConfig:
    seed: int = 0
    n_requests: int = 16
    rate_rps: float = 50.0          # Poisson arrival rate
    prompt_mix: LengthMixture = DEFAULT_PROMPT_MIX
    response_mix: LengthMixture = DEFAULT_RESPONSE_MIX
    vocab: int = 512                # prompt tokens drawn uniformly from here
    eos_id: int | None = None

    @property
    def worst_case_tokens(self) -> int:
        return self.prompt_mix.max_length + self.response_mix.max_length


def generate_requests(cfg: LoadGenConfig) -> list[GenerationRequest]:
    """Seeded Poisson workload; same seed -> identical request list."""
    rng = np.random.default_rng(cfg.seed)
    gaps = rng.exponential(1.0 / cfg.rate_rps, size=cfg.n_requests)
    arrivals = np.cumsum(gaps)
    prompt_lens = cfg.prompt_mix.sample(rng, cfg.n_requests)
    response_lens = cfg.response_mix.sample(rng, cfg.n_requests)
    requests = []
    for i in range(cfg.n_requests):
        prompt = rng.integers(0, cfg.vocab, size=int(prompt_lens[i]))
        requests.append(GenerationRequest(
            request_id=i,
            prompt=tuple(int(t) for t in prompt),
            max_new_tokens=int(response_lens[i]),
            arrival_s=float(arrivals[i]),
            eos_id=cfg.eos_id,
        ))
    return requests


def _pct(values, q) -> float:
    return float(np.percentile(np.asarray(values), q)) if len(values) else 0.0


@dataclasses.dataclass
class ServeReport:
    """Latency/throughput summary of one load-gen run."""

    n_requests: int
    n_completed: int
    total_tokens: int               # generated inside the measured window
    elapsed_s: float
    tokens_per_s: float
    goodput_tokens_per_s: float     # tokens of *completed* requests only
    ttft_p50_ms: float
    ttft_p99_ms: float
    per_token_p50_ms: float         # inter-token (decode cadence)
    per_token_p99_ms: float
    e2e_p50_ms: float
    e2e_p99_ms: float
    mean_batch_occupancy: float
    peak_pages_in_use: int

    @classmethod
    def from_run(cls, results: list[GenerationResult], stats: EngineStats
                 ) -> "ServeReport":
        ttft = [r.ttft_s * 1e3 for r in results]
        gaps = [g * 1e3 for r in results for g in r.inter_token_s()]
        e2e = [r.e2e_s * 1e3 for r in results]
        completed_tokens = sum(r.n_generated for r in results)
        elapsed = stats.elapsed_s
        return cls(
            n_requests=len(results),
            n_completed=len(results),
            total_tokens=stats.tokens_generated,
            elapsed_s=elapsed,
            tokens_per_s=stats.tokens_per_s,
            goodput_tokens_per_s=completed_tokens / elapsed if elapsed else 0.0,
            ttft_p50_ms=_pct(ttft, 50), ttft_p99_ms=_pct(ttft, 99),
            per_token_p50_ms=_pct(gaps, 50), per_token_p99_ms=_pct(gaps, 99),
            e2e_p50_ms=_pct(e2e, 50), e2e_p99_ms=_pct(e2e, 99),
            mean_batch_occupancy=stats.mean_occupancy,
            peak_pages_in_use=stats.peak_pages_in_use,
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        return (
            f"{self.n_completed}/{self.n_requests} requests, "
            f"{self.total_tokens} tokens in {self.elapsed_s:.2f}s "
            f"({self.tokens_per_s:.0f} tok/s, goodput "
            f"{self.goodput_tokens_per_s:.0f} tok/s)\n"
            f"TTFT p50/p99 {self.ttft_p50_ms:.1f}/{self.ttft_p99_ms:.1f} ms; "
            f"per-token p50/p99 {self.per_token_p50_ms:.1f}/"
            f"{self.per_token_p99_ms:.1f} ms; "
            f"e2e p50/p99 {self.e2e_p50_ms:.0f}/{self.e2e_p99_ms:.0f} ms\n"
            f"mean batch occupancy {self.mean_batch_occupancy:.2f}, "
            f"peak pages in use {self.peak_pages_in_use}"
        )


def run_benchmark(engine: ServeEngine, requests: list[GenerationRequest]
                  ) -> ServeReport:
    """Drive ``engine`` through ``requests`` and summarize."""
    results, stats = engine.run(requests)
    return ServeReport.from_run(results, stats)
