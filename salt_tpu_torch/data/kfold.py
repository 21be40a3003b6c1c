"""Depth-stratified K-fold splitter (own copy of
``salt_tpu/data/kfold.py``).

Reproduces the reference's ``KFoldBySortedValue`` exactly (reference:
common_blocks/utils.py:371-389): sort samples by a scalar value (depth z)
and stride-assign folds, so each fold spans the full depth range. Fold
membership is deterministic given the value vector — identical splits to
the reference for the same metadata, which the CV ensemble semantics
depend on (reference: main.py:631-656).
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class KFoldBySortedValue:
    def __init__(self, n_splits: int = 3, shuffle: bool = False,
                 random_state=None):
        # shuffle/random_state accepted for API parity; the reference never
        # uses them (stride assignment is deterministic).
        self.n_splits = n_splits
        self.shuffle = shuffle
        self.random_state = random_state

    def _iter_test_indices(self, X: np.ndarray) -> Iterator[np.ndarray]:
        X = np.asarray(X)
        order = np.argsort(X, kind="stable")
        for split_start in range(self.n_splits):
            yield order[split_start::self.n_splits]

    def split(self, X: np.ndarray, y=None, groups=None
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        X = np.asarray(X)
        indices = np.arange(X.shape[0])
        for test_idx in self._iter_test_indices(X):
            mask = np.zeros(X.shape[0], dtype=bool)
            mask[test_idx] = True
            yield indices[~mask], np.asarray(test_idx)

    def get_n_splits(self, X=None, y=None, groups=None) -> int:
        return self.n_splits
