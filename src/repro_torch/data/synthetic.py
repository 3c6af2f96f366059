"""Deterministic synthetic data pipelines.

A copy of ``repro.data.synthetic`` (numpy only), so the port imports
nothing of ``repro`` and the same seed gives identical batches in both
packages.

The paper's setting is *distributed* data: worker r draws from its own
local dataset D_r.  Every generator here is seeded per worker so the
R-worker batch [R, b, ...] is reproducible, and supports a ``non_iid``
knob that skews each worker's distribution (class subsets / distinct
Markov chains), which is where local-SGD/error-feedback effects bite.

No downloads: MNIST-shaped classification data comes from a fixed
random teacher model (so it is genuinely learnable and loss floors are
meaningful); LM tokens come from per-worker Markov chains over the
vocabulary (so next-token prediction has learnable structure).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


# ---------------------------------------------------------------------------
# classification (paper's convex experiments; ResNet images)
# ---------------------------------------------------------------------------


def make_classification_data(
    n: int,
    dim: int = 784,
    classes: int = 10,
    seed: int = 0,
    label_noise: float = 0.05,
):
    """Teacher-model data: x ~ N(0, I) (sparse-ish positive like pixel
    data), y = argmax(W* x + b* + noise)."""
    rng = np.random.RandomState(seed)
    W = rng.randn(dim, classes).astype(np.float32) / np.sqrt(dim)
    b = rng.randn(classes).astype(np.float32) * 0.1
    x = np.abs(rng.randn(n, dim)).astype(np.float32)
    x *= (rng.rand(n, dim) < 0.25)  # sparse activations, MNIST-ish
    logits = x @ W + b + label_noise * rng.randn(n, classes).astype(np.float32)
    y = np.argmax(logits, axis=1).astype(np.int32)
    return x, y


def mnist_like(n: int = 12000, seed: int = 0):
    return make_classification_data(n, dim=784, classes=10, seed=seed)


def make_image_data(n: int, hw: int = 16, channels: int = 3,
                    classes: int = 10, seed: int = 0):
    """CIFAR-shaped teacher data for the ResNet reproduction: class
    templates + noise."""
    rng = np.random.RandomState(seed)
    templates = rng.randn(classes, hw, hw, channels).astype(np.float32)
    y = rng.randint(0, classes, size=n).astype(np.int32)
    x = templates[y] + 1.5 * rng.randn(n, hw, hw, channels).astype(np.float32)
    return x, y


def worker_batches(
    x: np.ndarray,
    y: np.ndarray,
    R: int,
    batch: int,
    steps: int,
    seed: int = 0,
    non_iid: bool = False,
    feature_key: str = "features",
) -> Iterator[dict]:
    """Yields ``steps`` batches shaped [R, batch, ...].

    iid: the pool is split uniformly into R local datasets D_r.
    non_iid: worker r is biased toward classes r mod C (80/20 mix).
    """
    n = len(x)
    rng = np.random.RandomState(seed)
    if non_iid:
        classes = int(y.max()) + 1
        by_class = [np.where(y == c)[0] for c in range(classes)]
        shards = []
        for r in range(R):
            own = by_class[r % classes]
            other = np.concatenate(
                [by_class[c] for c in range(classes) if c != r % classes]
            )
            shards.append((own, other))
    else:
        perm = rng.permutation(n)
        shards = np.array_split(perm, R)
    for _ in range(steps):
        xs, ys = [], []
        for r in range(R):
            if non_iid:
                own, other = shards[r]
                n_own = int(0.8 * batch)
                idx = np.concatenate([
                    rng.choice(own, n_own),
                    rng.choice(other, batch - n_own),
                ])
            else:
                idx = rng.choice(shards[r], batch)
            xs.append(x[idx])
            ys.append(y[idx])
        yield {feature_key: np.stack(xs), "labels": np.stack(ys)}


# ---------------------------------------------------------------------------
# LM token streams
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LMTokenStream:
    """Per-worker Markov-chain token streams.

    Each worker gets its own transition matrix (non_iid) or a shared one
    (iid), over an effective alphabet of ``order`` states hashed into
    the full vocab, so cross-entropy has a real floor below log(vocab).
    """

    vocab: int
    R: int = 1
    order: int = 64
    seed: int = 0
    non_iid: bool = False

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        k = min(self.order, self.vocab)
        n_chains = self.R if self.non_iid else 1
        self.trans = []
        for _ in range(n_chains):
            t = rng.rand(k, k).astype(np.float64) ** 4  # peaky
            t /= t.sum(axis=1, keepdims=True)
            self.trans.append(t)
        self.state_to_token = rng.permutation(self.vocab)[:k]
        self.k = k

    def batches(self, batch: int, seq_len: int, steps: int,
                seed: int = 1) -> Iterator[dict]:
        """Yields {"tokens": [R, batch, seq_len + 1]} int32 batches."""
        rng = np.random.RandomState(seed)
        for _ in range(steps):
            out = np.zeros((self.R, batch, seq_len + 1), np.int32)
            for r in range(self.R):
                t = self.trans[r % len(self.trans)]
                s = rng.randint(0, self.k, size=batch)
                for j in range(seq_len + 1):
                    out[r, :, j] = self.state_to_token[s]
                    u = rng.rand(batch, 1)
                    s = (u > np.cumsum(t[s], axis=1)).sum(axis=1)
                    s = np.clip(s, 0, self.k - 1)
            yield {"tokens": out}
