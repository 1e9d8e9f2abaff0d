"""Deterministic multi-source batch composition.

Port of ``sm3det_tpu/data/sampler.py``: an infinite sampler over several
datasets that draws ``source_ratio[i]`` samples from dataset i per batch.
Every host enumerates the same global permutation stream of each source
(``RandomState(seed * 1000003 + source)``) and keeps its contiguous slice
of each global draw, so the batches of ``num_hosts`` hosts put together
are the one-host batch. The index streams equal the JAX package's for the
same seed, host id and number of hosts.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np


class MultiSourceSampler:
    """Yields batches of (source id, index within the source)."""

    def __init__(self, source_sizes: Sequence[int],
                 source_ratio: Sequence[int], seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1,
                 shuffle: bool = True):
        assert len(source_sizes) == len(source_ratio)
        self.sizes = list(source_sizes)
        self.ratio = list(source_ratio)
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.shuffle = shuffle

    def _stream(self, source: int) -> Iterator[int]:
        """The infinite global index stream of one source (the same on
        every host): one permutation an epoch."""
        n = self.sizes[source]
        rng = np.random.RandomState(self.seed * 1000003 + source)
        while True:
            perm = rng.permutation(n) if self.shuffle else np.arange(n)
            for i in range(n):
                yield int(perm[i])

    def __iter__(self) -> Iterator[List[Tuple[int, int]]]:
        """Per batch each source draws ``ratio[s] * num_hosts`` global
        indices, of which this host keeps
        ``[host_id * ratio[s], (host_id + 1) * ratio[s])``."""
        streams = [self._stream(s) for s in range(len(self.sizes))]
        while True:
            batch = []
            for s, r in enumerate(self.ratio):
                draw = [next(streams[s]) for _ in range(r * self.num_hosts)]
                batch.extend(
                    (s, draw[self.host_id * r + j]) for j in range(r))
            yield batch


class GroupMultiSourceSampler(MultiSourceSampler):
    """Aspect-ratio-grouped variant: each batch draws all samples of a
    source from one group (0 = landscape, 1 = portrait), chosen per source
    per batch in proportion to the groups' sizes from the global stream
    ``RandomState(seed * 7)``. ``group_of(source, index)`` gives a
    sample's group."""

    def __init__(self, source_sizes, source_ratio, group_of,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1):
        super().__init__(source_sizes, source_ratio, seed=seed,
                         host_id=host_id, num_hosts=num_hosts)
        self._group_indices = []
        for s, n in enumerate(self.sizes):
            groups = {0: [], 1: []}
            for i in range(n):
                groups[int(group_of(s, i)) & 1].append(i)
            self._group_indices.append(groups)

    def _stream_group(self, source: int, group: int) -> Iterator[int]:
        idxs = self._group_indices[source][group]
        rng = np.random.RandomState(
            self.seed * 1000003 + source * 31 + group)
        while True:
            perm = rng.permutation(len(idxs)) if self.shuffle \
                else np.arange(len(idxs))
            for i in range(len(idxs)):
                yield idxs[perm[i]]

    def __iter__(self):
        rng = np.random.RandomState(self.seed * 7)
        streams = {(s, g): self._stream_group(s, g)
                   for s in range(len(self.sizes)) for g in (0, 1)
                   if self._group_indices[s][g]}
        while True:
            batch = []
            for s, r in enumerate(self.ratio):
                sizes = [len(self._group_indices[s][g]) for g in (0, 1)]
                tot = max(sum(sizes), 1)
                g = int(rng.rand() >= sizes[0] / tot)
                if (s, g) not in streams:
                    g = 1 - g
                draw = [next(streams[(s, g)])
                        for _ in range(r * self.num_hosts)]
                batch.extend(
                    (s, draw[self.host_id * r + j]) for j in range(r))
            yield batch
