"""A multi-process input pipeline over a `torch.utils.data.DataLoader`:
the port of `dcnet_tpu/data/grain_pipeline.py` without `grain`.

`grain_loader` takes any of the map-style datasets (`VIDDataset`,
`ReferItDataset`) and yields collated numpy batches in
`data.vid.batch_iterator`'s order: a global shuffle seeded by `seed`
(epoch e of `num_epochs` by seed + e), then this shard's slice
(`shard_index::num_shards`), decoded in `num_workers` worker processes
(spawned: the caller may hold threads, which fork does not carry).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch.utils.data as tud


class _ShardSampler(tud.Sampler):
    def __init__(self, n: int, shuffle: bool, seed: int, num_epochs: Optional[int],
                 num_shards: int, shard_index: int):
        self.n, self.shuffle, self.seed = n, shuffle, seed
        self.num_epochs, self.num_shards, self.shard_index = (
            num_epochs, num_shards, shard_index)

    def epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        return order[self.shard_index::self.num_shards]

    def __iter__(self):
        epochs = itertools.count() if self.num_epochs is None else range(self.num_epochs)
        for e in epochs:
            yield from (int(i) for i in self.epoch_order(e))


def collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack numpy fields; other fields become lists."""
    out: Dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out


def grain_loader(
    dataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    num_epochs: Optional[int] = 1,
    num_workers: int = 0,
    num_shards: int = 1,
    shard_index: int = 0,
    drop_remainder: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields collated numpy batches like `batch_iterator`; `num_epochs`
    None repeats without end."""
    sampler = _ShardSampler(len(dataset), shuffle, seed, num_epochs,
                            num_shards, shard_index)
    loader = tud.DataLoader(dataset, batch_size=batch_size, sampler=sampler,
                            num_workers=num_workers, collate_fn=collate,
                            drop_last=drop_remainder,
                            multiprocessing_context="spawn" if num_workers else None)
    return iter(loader)
