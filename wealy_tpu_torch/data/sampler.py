"""Clique-positive sampling, a copy of ``wealy_tpu.data.sampler``, with the
seekable ``epoch_batches`` stream of training (batch b of epoch e is a pure
function of (seed, e, b)).

Split-local clique -> int labels with cross-split offsets (val labels start
after train's count, test after val's); per anchor ``n_per_class - 1``
positives from the same clique, without replacement where possible, with
optional ``p_samesong`` self-repeats and ``augment`` shuffling.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from wealy_tpu_torch.data.chunking import Item
from wealy_tpu_torch.data.metadata import SPLITS, Metadata


def split_clique_labels(md: Metadata) -> Dict[str, Dict[str, int]]:
    """split -> clique_id -> int label, with cross-split offsets."""
    out: Dict[str, Dict[str, int]] = {}
    offset = 0
    for split in SPLITS:
        cliques = list(md.splits[split].keys())
        out[split] = {c: offset + i for i, c in enumerate(cliques)}
        offset += len(cliques)
    return out


class CliqueSampler:
    """Iterates the versions of one split, emitting (label, [(id, emb), ...])
    items. ``load_fn(version_key)`` gives a (T, C) array or None;
    ``id_fn(version_key)`` the z_idx (default: the info entry's ``id``)."""

    def __init__(
        self,
        md: Metadata,
        split: str,
        load_fn: Callable[[str], Optional[np.ndarray]],
        n_per_class: int = 2,
        p_samesong: float = 0.0,
        augment: bool = False,
        seed: int = 0,
        id_fn: Optional[Callable[[str], int]] = None,
    ):
        if split not in SPLITS:
            raise ValueError(f"unknown split {split!r}; expected one of {SPLITS}")
        self.md = md
        self.split = split
        self.load_fn = load_fn
        self.n_per_class = n_per_class
        self.p_samesong = p_samesong
        self.augment = augment
        self.seed = int(seed)
        self.rng = np.random.default_rng(seed)
        self.labels = split_clique_labels(md)[split]
        self.id_fn = id_fn or (lambda v: int(md.info[v]["id"]))

        self.clique_of: Dict[str, str] = {}
        self.versions: List[str] = []
        for clique_id, versions in md.splits[split].items():
            for v in versions:
                self.versions.append(v)
                self.clique_of[v] = clique_id

    def __len__(self) -> int:
        return len(self.versions)

    def sample_item(self, index: int) -> Item:
        """Anchor = versions[index]; positives sampled from its clique."""
        anchor = self.versions[index]
        clique_id = self.clique_of[anchor]
        pool = [v for v in self.md.splits[self.split][clique_id] if v != anchor]
        chosen = [anchor]
        for _ in range(self.n_per_class - 1):
            if not pool or (self.p_samesong > 0 and self.rng.random() < self.p_samesong):
                chosen.append(anchor)  # self-repeat (p_samesong semantics)
            else:
                chosen.append(pool.pop(int(self.rng.integers(0, len(pool)))))
        if self.augment:
            self.rng.shuffle(chosen)
        return self.labels[clique_id], [(self.id_fn(v), self.load_fn(v)) for v in chosen]

    def epoch(self, shuffle: bool = True, batch_size: int = 16) -> Iterator[List[Item]]:
        """Lists of ``batch_size`` items; the incomplete last batch is dropped."""
        order = np.arange(len(self.versions))
        if shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            yield [self.sample_item(int(i)) for i in order[start : start + batch_size]]

    def n_batches(self, batch_size: int) -> int:
        return len(self.versions) // batch_size

    def epoch_batches(
        self, epoch: int, batch_size: int, start_batch: int = 0
    ) -> Iterator[tuple]:
        """Seekable deterministic epoch stream: the epoch order comes from
        ``default_rng([seed, epoch])`` and every batch's positive and chunk
        draws from ``default_rng([seed, epoch, b])``, so exact resume needs
        only (epoch, next_batch). Yields ``(b, batch_rng, items)``;
        ``batch_rng`` carries the rest of the batch's stream for the
        collate. The incomplete last batch is dropped."""
        order = np.arange(len(self.versions))
        np.random.default_rng([self.seed, epoch]).shuffle(order)
        for b in range(start_batch, len(order) // batch_size):
            rng = np.random.default_rng([self.seed, epoch, b])
            keep, self.rng = self.rng, rng  # sample_item draws from the batch stream
            items = [self.sample_item(int(i)) for i in order[b * batch_size : (b + 1) * batch_size]]
            self.rng = keep
            yield b, rng, items
