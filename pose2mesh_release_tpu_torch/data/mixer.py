"""Multi-dataset mixing (reference: data/multiple_datasets.py:6-40).

`MultipleDatasets` with make_same_len=True presents every dataset with
equal sampling probability: the virtual length is max(len) * n_datasets
and index i reads dataset i // max(len): item i % max(len) where that
is below the dataset's length and the length divides max(len), else a
uniform random item of it (partition-balanced, the reference semantics
where shorter sets resample uniformly).  As in the JAX package it has no
`get_batch`, so `BatchLoader` takes the per-sample path over a mix.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["MultipleDatasets"]


class MultipleDatasets:
    def __init__(self, dbs: Sequence, make_same_len: bool = True, seed: int = 0):
        self.dbs = list(dbs)
        self.db_num = len(self.dbs)
        self.max_db_data_num = max(len(db) for db in self.dbs)
        self.db_len_cumsum = np.cumsum([len(db) for db in self.dbs])
        self.make_same_len = make_same_len
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        if self.make_same_len:
            return self.max_db_data_num * self.db_num
        return int(self.db_len_cumsum[-1])

    def __getitem__(self, index: int):
        if self.make_same_len:
            db_idx = index // self.max_db_data_num
            data_idx = index % self.max_db_data_num
            n = len(self.dbs[db_idx])
            if data_idx >= n or self.max_db_data_num % n != 0:
                # uniform re-sample (multiple_datasets.py:28-33)
                data_idx = int(self.rng.integers(0, n))
            else:
                data_idx = data_idx % n
        else:
            for db_idx, cum in enumerate(self.db_len_cumsum):
                if index < cum:
                    break
            data_idx = index - (0 if db_idx == 0 else int(self.db_len_cumsum[db_idx - 1]))
        return self.dbs[db_idx][data_idx]
