from repro_torch.data.datasets import (
    instruction_examples,
    iter_chunks,
    iter_instruction_examples,
    iter_mixed_examples,
    iter_qa_examples,
    iter_summarization_examples,
    mixed_examples,
    qa_examples,
    rag_examples,
    summarization_examples,
)
from repro_torch.data.templates import render
from repro_torch.data.tokenizer import HashTokenizer

__all__ = [
    "HashTokenizer",
    "instruction_examples",
    "iter_chunks",
    "iter_instruction_examples",
    "iter_mixed_examples",
    "iter_qa_examples",
    "iter_summarization_examples",
    "mixed_examples",
    "qa_examples",
    "rag_examples",
    "render",
    "summarization_examples",
]
