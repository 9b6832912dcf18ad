"""The port's serving engine: counterparts of the reference's engine and
allocator tests, the load generator against the reference's (bit-identical),
and the slice as a whole -- the same seeded requests through
``repro.serve.ServeEngine`` and ``repro_torch.serve.ServeEngine`` from converted
weights give the same token streams (fp32, CPU)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ModelOptions as JaxOptions
from repro.models import build_model as jax_build_model
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import GenerationRequest as JaxRequest
from repro.serve import LengthMixture as JaxMixture
from repro.serve import LoadGenConfig as JaxLoadGenConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import generate_requests as jax_generate_requests
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import ModelOptions, build_model
from repro_torch.serve import (
    EngineConfig,
    GenerationRequest,
    LengthMixture,
    LoadGenConfig,
    OutOfPages,
    PageAllocator,
    PagedCacheConfig,
    PagedKVCache,
    ServeEngine,
    ServeReport,
    generate_requests,
    run_benchmark,
)

CFG = EngineConfig(max_batch=4, page_size=8, n_pages=32, max_blocks=4)


@pytest.fixture(scope="module")
def models():
    """One reference model and the port's model holding the same weights."""
    cfg_j = jax_get_config("glm4-9b").reduced()
    jm = jax_build_model(cfg_j, JaxOptions(compute_dtype="float32", remat=False))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config("glm4-9b").reduced()
    tm = build_model(cfg, ModelOptions("float32", "float32"), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, torch.float32, "cpu")
    return cfg, jm, jp, tm, tp


@pytest.fixture(scope="module")
def tiny_model(models):
    cfg, _, _, tm, tp = models
    return cfg, tm, tp


def _requests(cfg, n, seed=0, max_new=(4, 8), prompt_len=(3, 10)):
    rng = np.random.default_rng(seed)
    return [
        GenerationRequest(
            request_id=i,
            prompt=tuple(int(t) for t in rng.integers(
                0, cfg.vocab, int(rng.integers(*prompt_len)))),
            max_new_tokens=int(rng.integers(*max_new)),
        )
        for i in range(n)
    ]


# ------------------------------------------------------------------- engine
def test_engine_smoke(tiny_model):
    cfg, model, params = tiny_model
    engine = ServeEngine(model, params, CFG)
    requests = _requests(cfg, 6)
    results, stats = engine.run(requests)

    assert len(results) == 6
    for res, req in zip(results, requests):
        assert res.request_id == req.request_id
        assert len(res.tokens) == req.max_new_tokens
        assert all(0 <= t < cfg.vocab for t in res.tokens)
        assert len(res.token_times_s) == len(res.tokens)
        assert res.token_times_s == sorted(res.token_times_s)
        assert res.arrival_s <= res.admitted_s <= res.finished_s
    # exact token accounting: everything counted was generated in-window
    assert stats.tokens_generated == sum(r.max_new_tokens for r in requests)
    assert stats.elapsed_s > 0 and stats.tokens_per_s > 0
    # pages recycled: allocator ends fully free
    engine.cache.allocator.assert_all_free()
    assert engine.cache.allocator.n_free == CFG.n_pages


def _sequential_reference(model, params, prompt, n_tokens):
    """Greedy decode one sequence at a time via the dense cache path."""
    with torch.no_grad():
        cache = model.init_cache(1, 32)
        logits = None
        for t in prompt:
            logits, cache = model.decode_step(params, cache, torch.tensor([[t]]))
        tokens = [int(torch.argmax(logits[0, -1]))]
        while len(tokens) < n_tokens:
            logits, cache = model.decode_step(params, cache, torch.tensor([[tokens[-1]]]))
            tokens.append(int(torch.argmax(logits[0, -1])))
    return tokens


def test_continuous_batching_matches_sequential_decode(tiny_model):
    """The paged batched engine must produce exactly the tokens the dense
    one-at-a-time decode produces -- per-lane math is batch-invariant."""
    cfg, model, params = tiny_model
    engine = ServeEngine(model, params, EngineConfig(
        max_batch=3, page_size=8, n_pages=24, max_blocks=4))
    requests = _requests(cfg, 4, seed=7, max_new=(3, 7))
    results, _ = engine.run(requests)
    for res in results:
        ref = _sequential_reference(model, params, list(res.prompt), len(res.tokens))
        assert res.tokens == ref, f"request {res.request_id} diverged"


def test_mid_flight_admission_under_lane_pressure(tiny_model):
    cfg, model, params = tiny_model
    config = EngineConfig(max_batch=2, page_size=8, n_pages=16, max_blocks=4)
    engine = ServeEngine(model, params, config)
    results, stats = engine.run(_requests(cfg, 5, seed=3))
    assert len(results) == 5
    assert max(stats.occupancy) <= 2
    assert stats.peak_pages_in_use <= config.n_pages
    engine.cache.allocator.assert_all_free()


def test_oversized_request_rejected(tiny_model):
    cfg, model, params = tiny_model
    engine = ServeEngine(model, params, CFG)  # max context 32
    with pytest.raises(ValueError, match="max context"):
        engine.submit(GenerationRequest(
            request_id=0, prompt=(1,) * 20, max_new_tokens=20))
    small_pool = ServeEngine(model, params, EngineConfig(
        max_batch=2, page_size=8, n_pages=3, max_blocks=4))
    with pytest.raises(ValueError, match="never be admitted"):
        small_pool.submit(GenerationRequest(
            request_id=0, prompt=(1,) * 16, max_new_tokens=16))


def test_eos_stops_early(tiny_model):
    cfg, model, params = tiny_model
    probe = ServeEngine(model, params, CFG)
    [free_run], _ = probe.run(_requests(cfg, 1, seed=1, max_new=(6, 7)))
    assert len(free_run.tokens) >= 3

    eos = free_run.tokens[2]  # force a stop at the third generated token
    stop_at = free_run.tokens.index(eos) + 1
    engine = ServeEngine(model, params, CFG)
    req = GenerationRequest(
        request_id=0, prompt=free_run.prompt,
        max_new_tokens=len(free_run.tokens), eos_id=eos)
    [res], _ = engine.run([req])
    assert res.finish_reason == "eos"
    assert res.tokens == free_run.tokens[:stop_at]
    engine.cache.allocator.assert_all_free()


def test_prefill_only_request(tiny_model):
    """max_new_tokens=1 finishes at prefill without any decode tick."""
    cfg, model, params = tiny_model
    engine = ServeEngine(model, params, CFG)
    [res], stats = engine.run([GenerationRequest(
        request_id=0, prompt=(5, 6, 7), max_new_tokens=1)])
    assert len(res.tokens) == 1
    assert stats.prefills == 1 and stats.decode_steps == 0
    engine.cache.allocator.assert_all_free()


def test_deadline_timeout_mid_decode(tiny_model):
    cfg, model, params = tiny_model
    engine = ServeEngine(model, params, CFG)
    doomed = GenerationRequest(request_id=0, prompt=(1, 2, 3),
                               max_new_tokens=20, deadline_s=1e-6)
    healthy = GenerationRequest(request_id=1, prompt=(4, 5, 6),
                                max_new_tokens=4)
    results, stats = engine.run([doomed, healthy])

    assert stats.timeouts == 1
    by_id = {r.request_id: r for r in results}
    t = by_id[0]
    assert t.finish_reason == "timeout"
    assert 1 <= t.n_generated < doomed.max_new_tokens  # admitted, cut short
    assert by_id[1].finish_reason == "length"
    assert by_id[1].n_generated == 4
    engine.cache.allocator.assert_all_free()
    assert engine.cache.allocator.n_free == CFG.n_pages


def test_deadline_timeout_while_queued(tiny_model):
    cfg, model, params = tiny_model
    blockers = [
        GenerationRequest(request_id=i, prompt=(1, 2, 3), max_new_tokens=20)
        for i in range(CFG.max_batch)  # hold every lane for many ticks
    ]
    queued = GenerationRequest(request_id=CFG.max_batch, prompt=(7, 8),
                               max_new_tokens=4, deadline_s=1e-6)
    engine = ServeEngine(model, params, CFG)
    results, stats = engine.run(blockers + [queued])

    assert stats.timeouts == 1
    timed_out = [r for r in results if r.finish_reason == "timeout"]
    assert len(timed_out) == 1
    assert timed_out[0].request_id == queued.request_id
    assert timed_out[0].n_generated == 0  # never admitted
    for r in results:
        if r.request_id != queued.request_id:
            assert r.finish_reason == "length" and r.n_generated == 20
    engine.cache.allocator.assert_all_free()


def test_deadline_must_be_positive():
    with pytest.raises(ValueError):
        GenerationRequest(request_id=0, prompt=(1,), max_new_tokens=1,
                          deadline_s=0.0)


def test_request_validation():
    with pytest.raises(ValueError, match="empty prompt"):
        GenerationRequest(request_id=0, prompt=(), max_new_tokens=1)
    with pytest.raises(ValueError, match="max_new_tokens"):
        GenerationRequest(request_id=0, prompt=(1,), max_new_tokens=0)


def test_warmup_writes_no_page(tiny_model):
    """Warm-up runs inactive lanes and an empty block table: the pool (all but
    the spare page) is untouched and nothing is counted."""
    cfg, model, params = tiny_model
    engine = ServeEngine(model, params, CFG)
    engine._warmup(_requests(cfg, 3))
    for t in engine.cache.pages.values():
        assert t[:, : CFG.n_pages].abs().sum() == 0
    assert engine.stats.tokens_generated == 0 and engine.stats.prefills == 0


def test_engine_follows_the_models_device(tiny_model):
    _, model, params = tiny_model
    engine = ServeEngine(model, params, CFG)
    assert engine.device == model.device == torch.device("cpu")
    assert engine.cache.device_block_tables().device.type == "cpu"
    assert engine.cache.pages["k"].shape[1] == CFG.n_pages + 1   # the spare page


def test_prefill_bucket_is_power_of_two():
    assert [CFG.prefill_bucket(n) for n in (1, 8, 9, 100, 1024)] == [8, 8, 16, 128, 1024]


# ----------------------------------------------------- the slice as a whole
def test_same_requests_same_tokens_as_the_reference_engine(models):
    cfg, jm, jp, tm, tp = models
    mixes = dict(prompt_mix=((4, 0.5), (8, 0.3), (16, 0.2)),
                 response_mix=((8, 0.5), (16, 0.35), (32, 0.15)))
    shape = dict(max_batch=4, page_size=8, n_pages=48, max_blocks=6)
    load_j = JaxLoadGenConfig(seed=5, n_requests=10, rate_rps=200.0, vocab=cfg.vocab,
                              **{k: JaxMixture(v) for k, v in mixes.items()})
    load_t = LoadGenConfig(seed=5, n_requests=10, rate_rps=200.0, vocab=cfg.vocab,
                           **{k: LengthMixture(v) for k, v in mixes.items()})
    want, stats_j = JaxServeEngine(jm, jp, JaxEngineConfig(**shape)).run(
        jax_generate_requests(load_j))
    engine = ServeEngine(tm, tp, EngineConfig(**shape))
    got, stats_t = engine.run(generate_requests(load_t))
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        assert a.request_id == b.request_id and a.prompt == b.prompt
        assert a.tokens == b.tokens, f"request {a.request_id} diverged from the reference"
        assert a.finish_reason == b.finish_reason == "length"
    assert stats_t.tokens_generated == stats_j.tokens_generated
    assert stats_t.prefills == stats_j.prefills == 10
    engine.cache.allocator.assert_all_free()


# ------------------------------------------------------------------ loadgen
@pytest.mark.parametrize("seed", [0, 1, 42])
def test_generate_requests_is_bit_identical_to_the_reference(seed):
    got = generate_requests(LoadGenConfig(seed=seed, n_requests=32, vocab=1000, eos_id=3))
    want = jax_generate_requests(JaxLoadGenConfig(seed=seed, n_requests=32, vocab=1000, eos_id=3))
    assert len(got) == len(want) == 32
    for a, b in zip(got, want):
        assert isinstance(b, JaxRequest)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_length_mixture_validation():
    with pytest.raises(ValueError):
        LengthMixture(())
    with pytest.raises(ValueError):
        LengthMixture(((0, 1.0),))
    assert LengthMixture(((4, 1.0), (9, 1.0))).max_length == 9


def test_run_benchmark_report(tiny_model):
    cfg, model, params = tiny_model
    engine = ServeEngine(model, params, EngineConfig(
        max_batch=4, page_size=8, n_pages=48, max_blocks=6))
    report = run_benchmark(engine, generate_requests(
        LoadGenConfig(seed=0, n_requests=6, rate_rps=500.0, vocab=cfg.vocab)))
    assert isinstance(report, ServeReport)
    assert report.n_completed == report.n_requests == 6
    assert report.total_tokens > 0 and report.tokens_per_s > 0
    assert report.ttft_p50_ms <= report.ttft_p99_ms and report.e2e_p50_ms <= report.e2e_p99_ms
    assert 0 < report.mean_batch_occupancy <= 4
    assert set(report.to_dict()) >= {"tokens_per_s", "ttft_p50_ms", "per_token_p99_ms"}
    assert "tok/s" in report.summary()


# ---------------------------------------------------------------- allocator
class TestPageAllocator:
    def test_alloc_until_exhausted(self):
        a = PageAllocator(4)
        pages = [a.alloc(owner=0) for _ in range(4)]
        assert sorted(pages) == [0, 1, 2, 3]
        assert a.n_free == 0
        with pytest.raises(OutOfPages):
            a.alloc(owner=0)

    def test_free_recycles(self):
        a = PageAllocator(2)
        p = a.alloc(owner=1)
        a.free(p, owner=1)
        assert a.n_free == 2
        assert a.alloc(owner=2) == p  # LIFO reuse

    def test_double_free_raises(self):
        a = PageAllocator(2)
        p = a.alloc(owner=0)
        a.free(p, owner=0)
        with pytest.raises(ValueError, match="double free"):
            a.free(p, owner=0)

    def test_foreign_free_raises(self):
        a = PageAllocator(2)
        p = a.alloc(owner=0)
        with pytest.raises(ValueError, match="owned by lane 0"):
            a.free(p, owner=1)

    def test_pages_of_tracks_ownership(self):
        a = PageAllocator(4)
        mine = {a.alloc(owner=7) for _ in range(2)}
        a.alloc(owner=8)
        assert set(a.pages_of(7)) == mine

    def test_assert_all_free(self):
        a = PageAllocator(2)
        p = a.alloc(owner=0)
        with pytest.raises(AssertionError, match="leaked"):
            a.assert_all_free()
        a.free(p, owner=0)
        a.assert_all_free()

    def test_invalid_sizes_rejected(self):
        with pytest.raises(ValueError):
            PageAllocator(0)


class _FakeModel:
    """Stands in for DecoderLM: the cache only needs init_paged_cache."""

    def init_paged_cache(self, n_pages, page_size):
        return {"k": torch.zeros(2, n_pages + 1, page_size, 1, 4),
                "v": torch.zeros(2, n_pages + 1, page_size, 1, 4)}


def _cache(n_pages=8, page_size=4, max_batch=3, max_blocks=4):
    return PagedKVCache(_FakeModel(), PagedCacheConfig(
        n_pages=n_pages, page_size=page_size,
        max_batch=max_batch, max_blocks=max_blocks,
    ))


class TestPagedKVCache:
    def test_ensure_capacity_allocates_blocks_lazily(self):
        c = _cache()
        c.ensure_capacity(0, 1)
        assert c.n_blocks(0) == 1
        c.ensure_capacity(0, 4)   # still one page (page_size=4)
        assert c.n_blocks(0) == 1
        c.ensure_capacity(0, 5)   # crosses the boundary
        assert c.n_blocks(0) == 2
        assert c.allocator.n_free == 6

    def test_block_table_rows_are_disjoint(self):
        c = _cache()
        c.ensure_capacity(0, 8)
        c.ensure_capacity(1, 8)
        row0 = set(c.block_tables[0][c.block_tables[0] >= 0].tolist())
        row1 = set(c.block_tables[1][c.block_tables[1] >= 0].tolist())
        assert row0 and row1 and not (row0 & row1)

    def test_release_recycles_and_clears(self):
        c = _cache()
        c.ensure_capacity(2, 10)
        c.release(2)
        assert c.n_blocks(2) == 0
        assert (c.block_tables[2] == -1).all()
        c.allocator.assert_all_free()

    def test_max_context_enforced(self):
        c = _cache()
        with pytest.raises(ValueError, match="max context"):
            c.ensure_capacity(0, 17)  # 4 blocks * 4 tokens = 16 max

    def test_device_tables_are_copies(self):
        """The tensors handed to a step do not alias the host tables."""
        c = _cache()
        c.ensure_capacity(0, 4)
        tables, lane = c.device_block_tables(), c.lane_table(0)
        c.release(0)
        assert tables[0, 0].item() >= 0 and lane[0].item() >= 0
        assert tables.dtype == torch.int32 and tables.shape == (3, 4)

    def test_full_trace_leaves_no_leaks(self):
        rng = np.random.default_rng(0)
        c = _cache(n_pages=12, page_size=4, max_batch=4, max_blocks=3)
        lengths = [0] * 4
        for _ in range(300):
            lane = int(rng.integers(0, 4))
            if lengths[lane] and rng.random() < 0.3:
                c.release(lane)
                lengths[lane] = 0
            else:
                want = min(lengths[lane] + int(rng.integers(1, 5)), 12)
                try:
                    c.ensure_capacity(lane, want)
                    lengths[lane] = want
                except OutOfPages:
                    c.release(lane)
                    lengths[lane] = 0
            live = c.block_tables[c.block_tables >= 0]
            assert len(live) == len(set(live.tolist()))  # no aliased pages
            assert c.allocator.n_allocated == len(live)
        for lane in range(4):
            if lengths[lane]:
                c.release(lane)
        c.allocator.assert_all_free()
        assert c.allocator.n_free == 12
