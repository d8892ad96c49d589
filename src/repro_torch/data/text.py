"""Byte-level text corpus from local files, the port's copy of the JAX
package's ``data/text.py`` (numpy only, so the same ``root``, ``step`` and
``seed`` give the same bytes and windows bit for bit).

The paper's character-LM (§4.2) trains on WikiText-103, which is not
available offline; the corpus is this repository's own source and docs:
real, structured text with byte vocab 256, windows keyed by (step, index).
"""
from __future__ import annotations

import functools
import pathlib

import numpy as np

__all__ = ["byte_corpus", "text_batch"]


@functools.lru_cache(maxsize=4)
def byte_corpus(root: str = ".", exts: tuple[str, ...] = (".py", ".md")) -> np.ndarray:
    """Every ``exts`` file under ``root`` in sorted path order, joined by
    newlines, as a uint8 array (more than 10 000 bytes)."""
    chunks = []
    for p in sorted(pathlib.Path(root).rglob("*")):
        if p.suffix in exts and p.is_file() and "node_modules" not in str(p):
            try:
                chunks.append(p.read_bytes())
            except OSError:
                continue
    data = b"\n".join(chunks)
    if len(data) <= 10_000:
        raise ValueError(f"byte_corpus({root!r}): corpus too small ({len(data)} bytes)")
    return np.frombuffer(data, dtype=np.uint8)


def text_batch(step: int, batch: int, seq: int, *, corpus=None, seed: int = 23,
               host_id: int = 0, split: str = "train"):
    """``batch`` windows of ``seq + 1`` bytes -> {"tokens", "targets"}
    (batch, seq) int32 numpy arrays, the targets shifted by one.  The train
    split draws window starts from the first 95% of the corpus, the
    validation split from the rest."""
    corpus = byte_corpus() if corpus is None else corpus
    n = len(corpus) - seq - 1
    cut = int(n * 0.95)
    rng = np.random.default_rng(seed * 1_000_003 + step * 613 + host_id)
    if split == "train":
        starts = rng.integers(0, cut, size=batch)
    else:
        starts = rng.integers(cut, n, size=batch)
    idx = starts[:, None] + np.arange(seq + 1)[None, :]
    windows = corpus[idx]
    return {
        "tokens": windows[:, :-1].astype(np.int32),
        "targets": windows[:, 1:].astype(np.int32),
    }
