"""Synthetic RCV1-like sparse text-classification data (paper §6.2).

Generates a sparse feature matrix (features × examples, CSC-friendly) and
labels with a planted linear model, so HOGWILD! SGD measurably converges and
the training benchmark has a correctness signal, not just throughput.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_sparse_dataset(n_features: int = 512, n_examples: int = 4096,
                        density: float = 0.05, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (dense X (features, examples), labels (examples,), w_true)."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n_features, n_examples), np.float32)
    nnz = int(density * n_features)
    for c in range(n_examples):
        idx = rng.choice(n_features, size=nnz, replace=False)
        X[idx, c] = rng.standard_normal(nnz).astype(np.float32)
    w_true = rng.standard_normal(n_features).astype(np.float32)
    margin = w_true @ X
    y = (margin > 0).astype(np.float32) * 2 - 1        # ±1 labels
    return X, y, w_true


def hinge_loss(w: np.ndarray, X: np.ndarray, y: np.ndarray) -> float:
    margins = y * (w @ X)
    return float(np.maximum(0.0, 1.0 - margins).mean())


def accuracy(w: np.ndarray, X: np.ndarray, y: np.ndarray) -> float:
    return float((np.sign(w @ X) == y).mean())
