"""BERTScore's length limit, lifted: the port's kernel 7 keeps an example's
per-token state in dynamic shared memory sized at launch, so a
``MetricConfig("bertscore", params={"max_len": n})`` that the reference
takes is taken on the card too, up to what the card's shared memory
holds (Lc + Lr <= 21,731 tokens on compute capability 9.0), and any
embedding width.  A shape past that is refused when the task's metrics are
resolved, before any engine is called, on the CPU as on the card.  On the
CPU: the shape check, the refusal before inference (engine calls counted,
in memory and streaming), and BERTScore at 1,024 tokens a side against the
reference's."""

import importlib

import numpy as np
import pytest

import repro.core  # noqa: F401  (the reference's metrics import through core)
from repro.metrics import semantic as jax_semantic
from repro_torch.core import (
    EngineModelConfig,
    EvalSession,
    EvalTask,
    MetricConfig,
    StatisticsConfig,
    StreamingConfig,
)
from repro_torch.core import engines as port_engines
from repro_torch.data import iter_qa_examples
from repro_torch.kernels import _cuda
from repro_torch.kernels.bertscore.bertscore import (
    RING_BYTES,
    SM90_SMEM_OPTIN,
    TOKEN_BYTES,
    max_tokens,
    shape_error,
)
from repro_torch.metrics import resolve_metrics, semantic

#: the reference embedder's width
DIM = semantic.HashEmbedder().dim


def _bertscore(max_len):
    return MetricConfig("bertscore", "semantic", {"max_len": max_len})


@pytest.mark.parametrize("max_len", [64, 512, 1024, 2048, 10_865])
def test_the_shape_check_takes_long_inputs(max_len):
    """1,024 and 2,048 tokens a side at the reference embedder's width (past
    the 512 that fixed per-example arrays held) resolve, up to the most
    that compute capability 9.0's 227 KB of opt-in shared memory holds."""
    assert shape_error(max_len, max_len, DIM) is None
    assert shape_error(max_len, max_len, 4096) is None  # any width
    (name, _), = resolve_metrics([_bertscore(max_len)])
    assert name == "bertscore"


def test_the_limit_is_the_cards_shared_memory():
    """9 bytes a token beside the 36 KB ring: 21,731 tokens of both sides
    on compute capability 9.0; a card with less opt-in memory holds
    fewer."""
    assert RING_BYTES == 36_864 and TOKEN_BYTES == 9
    assert max_tokens() == (SM90_SMEM_OPTIN - RING_BYTES) // TOKEN_BYTES == 21_731
    assert shape_error(10_865, 10_866, DIM) is None
    assert "at most 21731 tokens" in shape_error(10_866, 10_866, DIM)
    assert shape_error(2048, 2048, DIM, smem_optin=64 * 1024) is not None
    assert shape_error(0, 5, DIM) is not None


@pytest.mark.parametrize("max_len", [0, 10_866, 1_000_000])
def test_an_impossible_shape_is_refused_when_resolved(max_len):
    with pytest.raises(ValueError, match=f"max_len={max_len}"):
        resolve_metrics([MetricConfig("exact_match"), _bertscore(max_len)])


@pytest.mark.parametrize("streaming", [False, True], ids=["in-memory", "streaming"])
def test_an_impossible_shape_is_refused_before_any_engine_call(monkeypatch,
                                                               streaming):
    """``run_task`` with BERTScore at 1,000,000 tokens a side raises before
    the engine is called (a check at the kernel's launch alone would come
    after every prompt has run); the same task at 1,024 tokens calls the
    engine and scores."""
    calls = []
    for name in ("infer", "infer_batch"):
        orig = getattr(port_engines.SimulatedAPIEngine, name)

        def counted(self, *a, _orig=orig, **kw):
            calls.append(1)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(port_engines.SimulatedAPIEngine, name, counted)

    def task(max_len):
        return EvalTask(
            task_id="bert-limit",
            model=EngineModelConfig(provider="openai", model_name="gpt-4o-mini",
                                    max_tokens=16),
            metrics=(MetricConfig("exact_match"), _bertscore(max_len)),
            statistics=StatisticsConfig(bootstrap_iterations=50,
                                        ci_method="percentile"),
            streaming=StreamingConfig(enabled=streaming, max_memory_rows=4),
        )

    with EvalSession(device="cpu") as session:
        with pytest.raises(ValueError, match="max_len=1000000"):
            session.run_task(iter_qa_examples(8, seed=0), task(1_000_000))
        assert calls == []
        result = session.run_task(iter_qa_examples(8, seed=0), task(1024))
    assert calls and np.isfinite(result.metrics["bertscore"].value)


def test_bertscore_at_1024_tokens_equals_the_reference():
    """The port's BERTScore at 1,024 tokens a side on the CPU (kernel 7's
    plain version) against the reference's, on texts of 5 to 900 words
    (past 512) and an empty one."""
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(300)]
    lens = (900, 5, 600, 0, 1024, 1300)
    preds = [" ".join(rng.choice(words, n)) for n in lens]
    refs = [" ".join(rng.choice(words, n)) for n in reversed(lens)]
    got = semantic.bertscore_f1(preds, refs, max_len=1024, device="cpu")
    want = jax_semantic.bertscore_f1(preds, refs, max_len=1024)
    finite = np.isfinite(want) & (np.abs(want) < 1e6)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-6)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))


def test_the_card_query_is_not_made_on_the_cpu(monkeypatch):
    """The shape check needs no card: resolving never builds the kernel
    library or asks a device."""
    def fail(*a, **kw):
        raise AssertionError("asked the card")

    module = importlib.import_module("repro_torch.kernels.bertscore.bertscore")
    monkeypatch.setattr(module, "device_smem_optin", fail)
    monkeypatch.setattr(_cuda, "library", fail)
    resolve_metrics([_bertscore(2048)])
