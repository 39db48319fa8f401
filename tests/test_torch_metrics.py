"""The port's lexical and semantic metrics (``repro_torch.metrics``)
against the JAX package's on the same strings: the hash embedder bit for
bit, the five lexical metrics exactly, ``embedding_similarity`` and
``bertscore_f1`` (on the CPU, through the kernel's plain version) within
1e-6; and the registry: params binding and hashing, the binary set,
every reference metric resolving and an unknown one refused before any
scoring."""

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.metrics: circular import)
from repro.data import iter_qa_examples as jax_rows
from repro.metrics import lexical as jax_lexical
from repro.metrics import semantic as jax_semantic
from repro.core.config import MetricConfig as JaxMetricConfig
from repro.metrics.registry import BINARY_METRICS as JAX_BINARY
from repro_torch.core import EvalTask, MetricConfig
from repro_torch.core.stages import EvalArtifact, ScoreStage
from repro_torch.data import iter_qa_examples
from repro_torch.metrics import (
    BINARY_METRICS,
    HashEmbedder,
    MetricContext,
    batch_lexical,
    bertscore_f1,
    embedding_similarity,
    get_metric,
    resolve_metrics,
)

LEXICAL = ("exact_match", "contains", "token_f1", "bleu", "rouge_l")

STRINGS = [
    "", " ", "   \t\n ", "!!!", "?", "a", "The", "the the the",
    "Hello, world!", "HELLO world", "hello   world", "naïve café résumé",
    "日本語のテキスト", "emoji 🙂 test 🙂",
    "Ünïcödé — dashes – and “quotes”",
    "x" * 80, "ab", "abc", "12345 678", "3.14159, 2.71828; 1.41421",
    "What is known about photosynthesis (case 3)?",
    "photosynthesis was first described in 1779",
    "It's a dog's life, isn't it?", "semi;colons:and/slashes\\too",
    "tab\tseparated\tvalues", "line\nbreaks\nhere",
    " ".join(f"word{i}" for i in range(100)),
    " ".join(["repeat"] * 70),
    "Mixed CASE and mixed case", "an apple a day",
]


def _pairs(n=48, seed=0):
    """QA references and perturbed responses: exact, recased and
    punctuated, words dropped, shuffled, padded, cut to a substring,
    unrelated, empty."""
    rng = np.random.default_rng(seed)
    refs = [r["reference"] for r in jax_rows(n, seed=seed)]
    assert refs == [r["reference"] for r in iter_qa_examples(n, seed=seed)]
    preds = []
    for i, ref in enumerate(refs):
        words = ref.split()
        kind = i % 8
        if kind == 0:
            pred = ref
        elif kind == 1:
            pred = "The " + ref.upper() + "!"
        elif kind == 2:
            keep = rng.random(len(words)) > 0.3
            pred = " ".join(w for w, k in zip(words, keep) if k)
        elif kind == 3:
            pred = " ".join(rng.permutation(words))
        elif kind == 4:
            pred = "I think " + ref + ", probably, as far as I know."
        elif kind == 5:
            pred = " ".join(words[1 : max(2, len(words) // 2)])
        elif kind == 6:
            pred = "completely unrelated answer text"
        else:
            pred = ""
        preds.append(pred)
    return preds, refs


@pytest.mark.parametrize("dim,ngram", [(256, (3, 5)), (64, (3, 5)), (256, (2, 4))])
def test_hash_embedder_is_bit_equal(dim, ngram):
    ours = HashEmbedder(dim, ngram)
    theirs = jax_semantic.HashEmbedder(dim, ngram)
    for s in STRINGS:
        np.testing.assert_array_equal(ours.embed(s), theirs.embed(s))
        for max_len in (1, 8, 64):
            a, am = ours.embed_tokens(s, max_len)
            b, bm = theirs.embed_tokens(s, max_len)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(am, bm)
    np.testing.assert_array_equal(ours.embed_batch(STRINGS),
                                  theirs.embed_batch(STRINGS))


@pytest.mark.parametrize("name", LEXICAL)
def test_lexical_metrics_equal_the_reference(name):
    preds, refs = _pairs()
    preds, refs = preds + STRINGS, refs + STRINGS[::-1]
    np.testing.assert_array_equal(
        batch_lexical(name, preds, refs),
        jax_lexical.batch_lexical(name, preds, refs),
    )


@pytest.mark.parametrize("name", ["exact_match", "contains"])
def test_unnormalized_option_equals_the_reference(name):
    preds, refs = _pairs(seed=1)
    got = batch_lexical(name, preds, refs, normalized=False)
    np.testing.assert_array_equal(
        got, jax_lexical.batch_lexical(name, preds, refs, normalized=False))
    # the option changes something on these pairs (recased, punctuated)
    assert not np.array_equal(got, batch_lexical(name, preds, refs))


def test_embedding_similarity_equals_the_reference():
    preds, refs = _pairs(seed=2)
    for emb in (None, HashEmbedder(64, (2, 4))):
        jemb = None if emb is None else jax_semantic.HashEmbedder(64, (2, 4))
        np.testing.assert_allclose(
            embedding_similarity(preds, refs, emb),
            jax_semantic.embedding_similarity(preds, refs, jemb),
            rtol=0, atol=1e-6,
        )


@pytest.mark.parametrize("max_len", [64, 5])
def test_bertscore_f1_equals_the_reference(max_len):
    preds, refs = _pairs(seed=3)
    # empty predictions are in the mix: F1 = -0.0 in both
    got = bertscore_f1(preds, refs, max_len=max_len, device="cpu")
    want = jax_semantic.bertscore_f1(preds, refs, max_len=max_len)
    assert got.dtype == np.float64 and got.shape == (len(preds),)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    empty = np.array([p == "" for p in preds])
    assert empty.any() and (got[empty] == 0).all()
    np.testing.assert_array_equal(np.signbit(got[empty]), np.signbit(want[empty]))


def test_binary_metrics_match_the_reference():
    assert BINARY_METRICS == JAX_BINARY


def test_params_are_bound_and_reach_the_scorer():
    preds, refs = _pairs(seed=4)
    rows = [{"reference": r} for r in refs]
    ctx = MetricContext(device=torch.device("cpu"))
    short = get_metric(MetricConfig("bertscore", type="semantic",
                                    params={"max_len": 3}))(rows, preds, ctx)
    np.testing.assert_allclose(
        short, jax_semantic.bertscore_f1(preds, refs, max_len=3),
        rtol=1e-6, atol=1e-6)
    raw = get_metric(MetricConfig("exact_match", params={"normalized": False}))
    np.testing.assert_array_equal(
        raw(rows, preds, ctx),
        jax_lexical.batch_lexical("exact_match", preds, refs, normalized=False))
    # params enter the hash as their JSON, as the reference's do, so a task
    # holding such configs hashes and configs differing in params differ
    assert hash(MetricConfig("bertscore", params={"max_len": 3})) == hash(
        JaxMetricConfig("bertscore", params={"max_len": 3}))
    assert hash(MetricConfig("bertscore", params={"max_len": 3})) != hash(
        MetricConfig("bertscore", params={"max_len": 4}))
    hash(EvalTask("t", metrics=(MetricConfig("contains",
                                             params={"normalized": False}),)))


@pytest.mark.parametrize(
    "name", ["llm_judge", "faithfulness", "context_relevance", "answer_relevance",
             "context_precision", "context_recall", "no_such_metric"])
def test_unported_metrics_raise_at_resolution(name):
    """Every metric of the reference's registry resolves now, the judge and
    RAG ones included; a name the registry does not know still raises
    before any inference runs."""
    cfgs = [MetricConfig("exact_match"), MetricConfig(name)]
    if name == "no_such_metric":
        with pytest.raises(KeyError, match="unknown metric"):
            resolve_metrics(cfgs)
    else:
        assert [n for n, _ in resolve_metrics(cfgs)] == ["exact_match", name]


def test_score_stage_scores_each_chunk_on_the_session_device(monkeypatch):
    import repro_torch.metrics.registry as registry

    devices = []
    real = registry.semantic.bertscore_f1

    def spy(preds, refs, **kw):
        devices.append(kw["device"])
        return real(preds, refs, **kw)

    monkeypatch.setattr(registry.semantic, "bertscore_f1", spy)

    class _Session:
        device = torch.device("cpu")
        judge_engine = None

    task = EvalTask("t", metrics=(MetricConfig("contains"),
                                  MetricConfig("bertscore", type="semantic")))
    stage = ScoreStage()
    preds, refs = _pairs(8, seed=5)
    for _ in range(3):
        art = EvalArtifact(rows=[{"reference": r} for r in refs], task=task)
        art.texts = preds
        art = stage.run(art, _Session())
    assert devices == [torch.device("cpu")] * 3
    assert sorted(art.scores) == ["bertscore", "contains"]
    np.testing.assert_array_equal(
        art.scores["contains"], jax_lexical.batch_lexical("contains", preds, refs))
    np.testing.assert_allclose(
        art.scores["bertscore"], jax_semantic.bertscore_f1(preds, refs),
        rtol=1e-6, atol=1e-6)
