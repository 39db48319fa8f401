"""Synthetic evaluation data, the port's copy of ``repro/data/datasets.py``
row for row: factual QA, summarization, instruction following, their
multi-domain mix and QA with retrieved contexts (for the RAG metrics), each
as a streaming iterator and as a list, and the chunker."""

from __future__ import annotations

import itertools
import random
from typing import Iterable, Iterator

_TOPICS = [
    "gravity", "photosynthesis", "volcanoes", "enzymes", "galaxies",
    "antibodies", "semiconductors", "glaciers", "neurons", "polymers",
    "currents", "isotopes", "ecosystems", "algorithms", "satellites",
]
_FACTS = [
    "was discovered in {year}", "operates through {n} distinct phases",
    "depends critically on temperature", "transfers energy between systems",
    "exhibits periodic behavior", "varies across {n} orders of magnitude",
]
_INSTR = [
    "Summarize the role of {topic} in two sentences.",
    "List {n} key properties of {topic}.",
    "Explain {topic} to a ten year old.",
    "Compare {topic} with {topic2} and highlight one difference.",
    "Write a short quiz question about {topic}.",
]


def iter_chunks(rows: Iterable[dict], chunk_size: int) -> Iterator[list[dict]]:
    """Yield fixed-size chunks from any example iterable (last may be short)."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    it = iter(rows)
    while chunk := list(itertools.islice(it, chunk_size)):
        yield chunk


def iter_qa_examples(n: int, seed: int = 0) -> Iterator[dict]:
    rng = random.Random(seed)
    for i in range(n):
        topic = rng.choice(_TOPICS)
        fact = rng.choice(_FACTS).format(year=1800 + rng.randint(0, 220),
                                         n=rng.randint(2, 9))
        yield {
            "id": f"qa-{seed}-{i}",
            "question": f"What is known about {topic} (case {i})?",
            "reference": f"{topic} {fact}",
            "domain": "qa",
        }


def iter_summarization_examples(n: int, seed: int = 0) -> Iterator[dict]:
    rng = random.Random(seed + 1)
    for i in range(n):
        topic = rng.choice(_TOPICS)
        sents = [
            f"{topic} "
            + rng.choice(_FACTS).format(year=1900 + rng.randint(0, 120),
                                        n=rng.randint(2, 9))
            + "."
            for _ in range(rng.randint(4, 8))
        ]
        yield {
            "id": f"sum-{seed}-{i}",
            "question": f"Summarize: {' '.join(sents)}",
            "reference": sents[0],
            "domain": "summarization",
        }


def iter_instruction_examples(n: int, seed: int = 0) -> Iterator[dict]:
    rng = random.Random(seed + 2)
    for i in range(n):
        topic, topic2 = rng.sample(_TOPICS, 2)
        instr = rng.choice(_INSTR).format(topic=topic, topic2=topic2,
                                          n=rng.randint(2, 5))
        yield {
            "id": f"instr-{seed}-{i}",
            "question": instr,
            "reference": f"A helpful response about {topic}.",
            "domain": "instruction",
        }


def iter_mixed_examples(n: int, seed: int = 0) -> Iterator[dict]:
    """The three domains interleaved by a seeded weighted draw, O(1)
    memory.  The order differs from :func:`mixed_examples` (a shuffle of
    the whole list); each domain's rows are the same."""
    per = n // 3
    streams = [
        iter_qa_examples(per, seed),
        iter_summarization_examples(per, seed),
        iter_instruction_examples(n - 2 * per, seed),
    ]
    remaining = [per, per, n - 2 * per]
    rng = random.Random(seed + 3)
    while any(remaining):
        pick = rng.randrange(sum(remaining))
        for d in range(3):
            if pick < remaining[d]:
                remaining[d] -= 1
                yield next(streams[d])
                break
            pick -= remaining[d]


def qa_examples(n: int, seed: int = 0) -> list[dict]:
    return list(iter_qa_examples(n, seed))


def summarization_examples(n: int, seed: int = 0) -> list[dict]:
    return list(iter_summarization_examples(n, seed))


def instruction_examples(n: int, seed: int = 0) -> list[dict]:
    return list(iter_instruction_examples(n, seed))


def mixed_examples(n: int, seed: int = 0) -> list[dict]:
    """The multi-domain evaluation mix: the three lists, shuffled."""
    per = n // 3
    out = (
        qa_examples(per, seed)
        + summarization_examples(per, seed)
        + instruction_examples(n - 2 * per, seed)
    )
    random.Random(seed + 3).shuffle(out)
    return out


def rag_examples(n: int, seed: int = 0) -> list[dict]:
    """QA rows with three retrieved-context chunks each, the reference's
    fact second between two distractors, for the RAG metrics."""
    rng = random.Random(seed + 4)
    out = []
    for i, ex in enumerate(qa_examples(n, seed)):
        distractors = [
            f"{rng.choice(_TOPICS)} {rng.choice(_FACTS).format(year=1950, n=3)}"
            for _ in range(2)
        ]
        ex.update({
            "id": f"rag-{seed}-{i}",
            "contexts": distractors[:1] + [ex["reference"]] + distractors[1:],
            "relevant_index": 1,
            "domain": "rag",
        })
        out.append(ex)
    return out
