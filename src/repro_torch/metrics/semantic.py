"""Semantic metrics (the port's copy of ``repro/metrics/semantic.py``):
embedding cosine similarity and BERTScore over the deterministic
feature-hashing embedder.

The embeddings are made on the host with numpy, as in the reference; the
BERTScore greedy matching runs on ``device`` through
:func:`repro_torch.kernels.bertscore.bertscore` (the Hopper kernel on the
card, its plain version on the CPU)."""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.bertscore import bertscore
from repro_torch.kernels.bertscore.bertscore import shape_error

#: BERTScore's default tokens a side (``params={"max_len": n}`` sets it)
BERTSCORE_MAX_LEN = 64


class HashEmbedder:
    """Deterministic n-gram feature-hashing embedder."""

    def __init__(self, dim: int = 256, ngram: tuple[int, int] = (3, 5)):
        self.dim = dim
        self.ngram = ngram

    def _features(self, text: str) -> list[str]:
        text = " ".join(text.lower().split())
        feats = text.split()
        padded = f" {text} "
        lo, hi = self.ngram
        for n in range(lo, hi + 1):
            feats.extend(padded[i : i + n] for i in range(len(padded) - n + 1))
        return feats

    def _bucket(self, feat: str) -> tuple[int, float]:
        h = hashlib.md5(feat.encode()).digest()
        idx = int.from_bytes(h[:4], "little") % self.dim
        sign = 1.0 if h[4] & 1 else -1.0
        return idx, sign

    def embed(self, text: str) -> np.ndarray:
        v = np.zeros(self.dim, np.float32)
        for f in self._features(text):
            idx, sign = self._bucket(f)
            v[idx] += sign
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    def embed_batch(self, texts: list[str]) -> np.ndarray:
        return np.stack([self.embed(t) for t in texts])

    def embed_tokens(self, text: str, max_len: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-word embeddings (for BERTScore): (max_len, dim), mask."""
        words = text.lower().split()[:max_len]
        out = np.zeros((max_len, self.dim), np.float32)
        mask = np.zeros(max_len, np.float32)
        for i, w in enumerate(words):
            out[i] = self.embed(w)
            mask[i] = 1.0
        return out, mask


_DEFAULT = HashEmbedder()


def embedding_similarity(
    preds: list[str], refs: list[str], embedder: HashEmbedder | None = None
) -> np.ndarray:
    emb = embedder or _DEFAULT
    p = emb.embed_batch(preds)
    r = emb.embed_batch(refs)
    return np.clip(np.sum(p * r, axis=1), -1.0, 1.0).astype(np.float64)


def check_bertscore(max_len: int = BERTSCORE_MAX_LEN, **_) -> None:
    """Refuse a BERTScore config whose shape the kernel cannot take on the
    card (``max_len`` tokens a side at the default embedder's width), so
    that it fails when the task's metrics are resolved, before any
    inference, on the CPU as on the card; raises ``ValueError``."""
    why = shape_error(max_len, max_len, _DEFAULT.dim)
    if why is not None:
        raise ValueError(f"bertscore params max_len={max_len}: {why}")


def bertscore_f1(
    preds: list[str],
    refs: list[str],
    embedder: HashEmbedder | None = None,
    *,
    max_len: int = BERTSCORE_MAX_LEN,
    device: torch.device | str | None,
) -> np.ndarray:
    """BERTScore F1 per example.  ``device=None`` is the card."""
    emb = embedder or _DEFAULT
    cand = np.zeros((len(preds), max_len, emb.dim), np.float32)
    ref = np.zeros((len(refs), max_len, emb.dim), np.float32)
    cmask = np.zeros((len(preds), max_len), np.float32)
    rmask = np.zeros((len(refs), max_len), np.float32)
    for i, (p, r) in enumerate(zip(preds, refs)):
        cand[i], cmask[i] = emb.embed_tokens(p, max_len)
        ref[i], rmask[i] = emb.embed_tokens(r, max_len)
    dev = resolve_device(device)
    arrays = (cand, ref, cmask, rmask)
    _, _, f1 = bertscore(*(torch.from_numpy(a).to(dev) for a in arrays))
    return f1.cpu().numpy().astype(np.float64)
