"""The port's paged ``ContinuousBatcher`` (f32 and int8 page pools, prefix
sharing, preemption) against the JAX package's, and the paged path's own
invariants inside the port: page-size invariance, prefix sharing that
changes no token, byte-identical int8 runs, preemption that changes no
token, copy-on-write that copies bytes and scales verbatim, and the
cache-dtype validation of the engine and the batcher.

Reduced qwen3-4b on the CPU (the kernels' plain versions), with the
workloads of ``tests/test_quantized_serving.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import params as jax_pm
from repro.models.model import TransformerLM as JaxLM
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.core import EngineModelConfig, TorchLocalEngine
from repro_torch.models import TransformerLM, params_from_jax
from repro_torch.serve import ContinuousBatcher, Request

N_SLOTS, MAX_LEN, PAGE = 4, 64, 16
#: counters the two batchers must agree on
COUNTERS = ("prefix_pages_hit", "prefix_tokens_saved", "preemptions", "cow_copies")
#: the largest JAX top-two logit gap at which the port's int8 run may pick
#: another token.  The two frameworks sum the f32 model in other orders, so
#: a K/V element can land on the other side of an int8 rounding step: one
#: step is absmax/127 of its (page, head) group, about 1% of the group's
#: largest value, and moves a logit of the reduced model by well under
#: this.
INT8_GAP_TOL = 5e-2


class _JaxF32:
    """Test-side wrapper: the JAX model with every call in f32."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg

    def cache_specs(self, *a, **kw):
        return self.model.cache_specs(*a, **kw)

    def prefill(self, params, batch, cache, start=0):
        return self.model.prefill(params, batch, cache, dtype=jnp.float32,
                                  start=start)

    def decode_step(self, params, tokens, cache, positions):
        return self.model.decode_step(params, tokens, cache, positions,
                                      dtype=jnp.float32)


class _PortF32(TransformerLM):
    def prefill(self, *a, **kw):
        return super().prefill(*a, dtype=torch.float32, **kw)

    def decode_step(self, *a, **kw):
        return super().decode_step(*a, dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def ref():
    cfg = jax_get_config("qwen3-4b").reduced()
    model = JaxLM(cfg, remat="none")
    params = jax_pm.init_params(jax.random.key(1), model.param_specs())
    return cfg, model, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def port_cfg():
    return get_config("qwen3-4b").reduced()


def _params(ref, cfg, dtype=torch.float32):
    return params_from_jax(ref[3], cfg, device="cpu", dtype=dtype)


def _workload(vocab_size, seed, n=10):
    """tests/test_quantized_serving.py:47's workload: shared-prefix plus
    unique-tail prompts, 15-23 prompt tokens, 12 new tokens."""
    rng = np.random.default_rng(seed)
    shared = list(rng.integers(2, vocab_size, 20))
    out = []
    for i in range(n):
        toks = shared[: 12 + (i % 5)] + list(rng.integers(2, vocab_size, 3 + i % 7))
        out.append((i, [int(t) for t in toks], 12))
    return out


def _pressure(vocab_size):
    """tests/test_quantized_serving.py:98's workload: short prompts, long
    generations, so decode growth outruns the admission gate's one-page
    reserve in a pool of 8 pages."""
    rng = np.random.default_rng(11)
    return [(i, [int(t) for t in rng.integers(2, vocab_size, 10 + i % 5)], 40)
            for i in range(8)]


def _at_max_len():
    """tests/test_torch_serving.py's stale-slot workload: request 0 ends at
    position max_len and then sits free at that stale position while
    request 1 decodes on; request 2 decodes one step *at* max_len, which
    keeps no new row and attends over all max_len positions."""
    rng = np.random.default_rng(5)
    p = [[int(t) for t in rng.integers(4, 512, n)] for n in (20, 10, 30)]
    return [(0, p[0], MAX_LEN - 20 + 1), (1, p[1], 50),
            (2, p[2], MAX_LEN - 30 + 2)]


WORKLOADS = {
    "seed11": lambda: _workload(512, 11),
    "seed4": lambda: _workload(512, 4),
    "pressure": lambda: _pressure(512),
    "max_len": _at_max_len,
}


def _run_port(cfg, params, work, model_cls=_PortF32, **kw):
    kw = {"n_slots": N_SLOTS, "max_len": MAX_LEN, "page_size": PAGE, **kw}
    sched = ContinuousBatcher(model_cls(cfg), cfg, params, eos_id=1, **kw)
    for rid, toks, n_new in work:
        sched.submit(Request(rid, prompt_tokens=toks, max_new_tokens=n_new))
    out = {c.request_id: (c.tokens, c.finished_reason)
           for c in sched.run_to_completion()}
    return sched, out


def _run_jax(ref, work, **kw):
    """The JAX paged batcher in f32; also records, per request, the logits
    rows that chose its tokens (prefill, then each decode step)."""
    cfg, model, params, _ = ref
    sched = JaxBatcher(_JaxF32(model), cfg, params, n_slots=N_SLOTS,
                       max_len=MAX_LEN, eos_id=1, page_size=PAGE, **kw)
    rows: dict[int, list[np.ndarray]] = {}
    admitting = [None]  # the request whose prompt is being prefilled

    def admit(req, _orig=sched._admit):
        admitting[0] = req.request_id
        _orig(req)

    def prefill(*a, _orig=sched._prefill):
        out = _orig(*a)
        rows[admitting[0]] = [np.asarray(out[0], np.float32)[0]]
        return out

    def decode(*a, _orig=getattr(sched, "_paged_decode_q", None)
               or sched._paged_decode):
        out = _orig(*a)
        logits = np.asarray(out[0], np.float32)
        for s in range(N_SLOTS):
            if not sched.slot_free[s]:
                rows[sched.slot_req[s].request_id].append(logits[s])
        return out

    sched._admit, sched._prefill = admit, prefill
    if sched.quantized:
        sched._paged_decode_q = decode
    else:
        sched._paged_decode = decode
    for rid, toks, n_new in work:
        sched.submit(JaxRequest(rid, prompt_tokens=toks, max_new_tokens=n_new))
    out = {c.request_id: (c.tokens, c.finished_reason)
           for c in sched.run_to_completion()}
    return sched, out, rows


# -- against the JAX batcher --------------------------------------------------------


@pytest.mark.parametrize(
    "work,page_pool",
    [("seed11", 0), ("seed4", 0), ("seed11", 8), ("seed4", 8), ("pressure", 8),
     ("max_len", 0)],
)
def test_f32_pool_tokens_and_counters_equal_jax(ref, port_cfg, work, page_pool):
    reqs = WORKLOADS[work]()
    jsched, want, _ = _run_jax(ref, reqs, page_pool=page_pool)
    psched, got = _run_port(port_cfg, _params(ref, port_cfg), reqs,
                            page_pool=page_pool)
    assert got == want
    for name in COUNTERS:
        assert getattr(psched.stats, name) == getattr(jsched.stats, name), name
    assert psched.stats.kv_bytes_per_token == jsched.stats.kv_bytes_per_token
    assert psched.stats.pool_pages == jsched.stats.pool_pages
    if work.startswith("seed") and page_pool == 0:
        assert psched.stats.prefix_tokens_saved > 0
    if work == "max_len":
        assert MAX_LEN in psched.slot_pos.tolist()
    if work == "pressure":
        assert psched.stats.preemptions > 0
    psched.manager.check_no_leaks()


@pytest.mark.parametrize("work", ["seed11", "seed4", "max_len"])
def test_int8_pool_tokens_equal_jax_off_thin_gaps(ref, port_cfg, work):
    """Every request's tokens equal the JAX int8 batcher's, except where
    they first differ at a step whose JAX top-two logit gap is under
    ``INT8_GAP_TOL``."""
    reqs = WORKLOADS[work]()
    jsched, want, rows = _run_jax(ref, reqs, kv_cache_dtype="int8")
    psched, got = _run_port(port_cfg, _params(ref, port_cfg), reqs,
                            kv_cache_dtype="int8")
    assert sorted(got) == sorted(want) == list(range(len(reqs)))
    for name in COUNTERS + ("kv_bytes_per_token", "pool_pages"):
        assert getattr(psched.stats, name) == getattr(jsched.stats, name), name
    for rid, (toks, _) in want.items():
        if got[rid][0] == toks:
            continue
        step = next(t for t, (a, b) in enumerate(zip(got[rid][0], toks)) if a != b)
        top = np.sort(rows[rid][step][:512])
        assert top[-1] - top[-2] < INT8_GAP_TOL, (rid, step, top[-1] - top[-2])


# -- within the port ----------------------------------------------------------------


@pytest.mark.parametrize("page_size", [8, 16, 32])
def test_paged_without_sharing_gives_the_contiguous_tokens(ref, port_cfg, page_size):
    """bf16, the serving default: without prefix sharing a prompt's prefill
    is the contiguous one, and paged decode reads the same rows."""
    params = _params(ref, port_cfg, torch.bfloat16)
    work = _workload(512, 11)
    _, want = _run_port(port_cfg, params, work, model_cls=TransformerLM, page_size=0)
    _, got = _run_port(port_cfg, params, work, model_cls=TransformerLM,
                       page_size=page_size, prefix_cache=False)
    assert got == want


def test_prefix_sharing_changes_no_token(ref, port_cfg):
    params = _params(ref, port_cfg)
    work = _workload(512, 4)
    _, want = _run_port(port_cfg, params, work, page_size=0)
    sched, got = _run_port(port_cfg, params, work, prefix_cache=True)
    assert got == want
    assert sched.stats.prefix_tokens_saved > 0


def _pool_bytes(sched):
    c = sched.cache
    return [t.clone() for t in (c.k, c.v, c.k_scale, c.v_scale) if t is not None]


def test_int8_runs_are_byte_identical(ref, port_cfg):
    params = _params(ref, port_cfg)
    work = _workload(512, 11)
    a, ta = _run_port(port_cfg, params, work, kv_cache_dtype="int8")
    b, tb = _run_port(port_cfg, params, work, kv_cache_dtype="int8")
    assert ta == tb
    for x, y in zip(_pool_bytes(a), _pool_bytes(b)):
        assert torch.equal(x, y)
    assert a.cache.k.dtype == torch.int8 and a.stats.kv_bytes_per_token == 260


def test_int8_under_pool_pressure_gives_the_roomy_tokens(ref, port_cfg):
    params = _params(ref, port_cfg)
    work = _pressure(512)
    roomy, a = _run_port(port_cfg, params, work, kv_cache_dtype="int8")
    tight, b = _run_port(port_cfg, params, work, kv_cache_dtype="int8", page_pool=8)
    assert tight.stats.preemptions > 0 and roomy.stats.preemptions == 0
    assert a == b
    tight.manager.check_no_leaks()


@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8"])
def test_forced_copy_on_write_copies_bytes_and_scales(ref, port_cfg, kv_cache_dtype):
    """Pull an active slot's next position back into its full, indexed
    first page: the step's tables copy that page on write, bytes and
    scales verbatim, and leave every other page as it was."""
    params = _params(ref, port_cfg)
    sched = ContinuousBatcher(_PortF32(port_cfg), port_cfg, params, n_slots=2,
                              max_len=MAX_LEN, page_size=PAGE,
                              kv_cache_dtype=kv_cache_dtype)
    sched.submit(Request(0, prompt_tokens=list(range(10, 30)), max_new_tokens=8))
    sched.step()
    src = sched.manager.table(0)[0]
    before = _pool_bytes(sched)
    sched.slot_pos[0] = 5
    pages = sched._paged_step_tables([0])
    dst = sched.manager.table(0)[0]
    assert dst != src and sched.stats.cow_copies == 1
    assert int(pages.write_pages[0]) == dst and int(pages.write_offsets[0]) == 5
    after = _pool_bytes(sched)
    keep = [p for p in range(before[0].shape[1]) if p != dst]
    for b, a in zip(before, after):
        assert torch.equal(a[:, dst], b[:, src])
        assert torch.equal(a[:, keep], b[:, keep])


@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8"])
def test_page_pool_bytes_sizes_the_pool_as_jax(ref, port_cfg, kv_cache_dtype):
    """A byte budget buys the reference's page count: the "bf16" pool is
    charged 4 bytes an element (it is f32), the int8 pool one byte plus its
    scales, so the same budget holds about four times the int8 pages."""
    cfg, model, params, _ = ref
    budget = 20 * PAGE * 1024
    kw = {"n_slots": N_SLOTS, "max_len": MAX_LEN, "page_size": PAGE,
          "kv_cache_dtype": kv_cache_dtype, "page_pool_bytes": budget}
    jsched = JaxBatcher(_JaxF32(model), cfg, params, **kw)
    psched = ContinuousBatcher(TransformerLM(port_cfg), port_cfg,
                               _params(ref, port_cfg), **kw)
    assert psched.stats.pool_pages == jsched.stats.pool_pages
    assert psched.stats.kv_bytes_per_token == jsched.stats.kv_bytes_per_token
    assert psched.cache.k.shape[1] == psched.stats.pool_pages + 1  # + trash
    with pytest.raises(ValueError, match="mutually exclusive"):
        ContinuousBatcher(TransformerLM(port_cfg), port_cfg,
                          _params(ref, port_cfg), page_pool=8, **kw)


def test_cache_dtype_validation():
    cfg = get_config("qwen3-4b").reduced()
    model = EngineModelConfig(provider="torch_local", reduced=True)
    with pytest.raises(ValueError, match="requires a paged cache"):
        TorchLocalEngine(model, device="cpu", kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="must be 'bf16' or 'int8'"):
        TorchLocalEngine(model, device="cpu", kv_page_size=16, kv_cache_dtype="fp8")
    params = {"embed": torch.zeros(1)}
    with pytest.raises(ValueError, match="requires a paged cache"):
        ContinuousBatcher(TransformerLM(cfg), cfg, params, kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="must be 'bf16' or 'int8'"):
        ContinuousBatcher(TransformerLM(cfg), cfg, params, page_size=16,
                          kv_cache_dtype="f32")
    with pytest.raises(ValueError, match="multiple of page_size"):
        ContinuousBatcher(TransformerLM(cfg), cfg, params, max_len=60, page_size=16)
