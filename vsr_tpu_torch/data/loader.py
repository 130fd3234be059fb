"""Batched, prefetching data loader (port of ``vsr_tpu/data/loader.py``).

- A thread pool decodes samples: decode is zlib + numpy (GIL-releasing), so
  threads overlap IO and decode without pickling.
- Deterministic per-sample RNG: each sample's augmentation Generator is
  derived from (root seed, "data", epoch, global sample index) via
  :class:`~vsr_tpu_torch.utils.rng.RngTree`, so results are independent of
  worker count and schedule.
- Channels-last numpy batches; the trainer moves each to the device through
  pinned memory and permutes it to the nets' layout.
- ``host_shard`` (multi-process training): every rank computes the same
  epoch order (the ``RngTree`` seed is shared), splits it into global
  batches of ``batch_size * world`` samples and loads only its own
  ``batch_size`` block of each, so the ranks' batches at step k together
  are the single-process batch of that global size at step k, with the same
  crops (a sample's RNG is keyed by its global index); ``__len__`` drops
  the ragged tail across the ranks.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Mapping

import numpy as np

from vsr_tpu_torch.parallel.distributed import process_count, process_index
from vsr_tpu_torch.registry import register
from vsr_tpu_torch.utils.rng import RngTree


def default_collate(samples: list[Mapping[str, Any]]) -> dict[str, np.ndarray]:
    """Stack sample dicts along a leading batch axis."""
    batch: dict[str, np.ndarray] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            batch[key] = np.stack(vals, axis=0)
        else:
            batch[key] = np.asarray(vals)
    return batch


@register("loader")
class Dataloader:
    """Iterates epoch batches of a dataset.

    Args:
        dataset: an object with ``__len__`` and ``__getitem__(i, rng=...)``.
        batch_size: samples per batch.
        shuffle: reshuffle each epoch (train).
        num_workers: decode threads (0 = synchronous).
        drop_last: drop the trailing partial batch.
        prefetch: number of batches decoded ahead of the consumer.
        collate_fn: override batch assembly (defaults to stacking).
        host_shard: each rank loads its block of every global batch.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        num_workers: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
        collate_fn=None,
        host_shard: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.num_workers = int(num_workers)
        self.drop_last = bool(drop_last)
        self.prefetch = max(int(prefetch), 1)
        self.collate_fn = collate_fn or default_collate
        self.host_shard = bool(host_shard)
        # (count, index) of this rank's data block when the mesh's 'data'
        # axis does not span every rank (a 'model' or 'expert' axis): the
        # ranks of one block read the same samples.
        self._host_shard_override: tuple[int, int] | None = None

    def _shard_info(self) -> tuple[int, int]:
        """(shard_count, shard_index) when host-sharding, else (1, 0)."""
        if not self.host_shard:
            return 1, 0
        if self._host_shard_override is not None:
            return self._host_shard_override
        return process_count(), process_index()

    def __len__(self) -> int:
        n = len(self.dataset)
        nproc, _ = self._shard_info()
        if nproc > 1:
            return n // (self.batch_size * nproc)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self, epoch_rng: np.random.Generator | None) -> list[list[int]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            if epoch_rng is None:
                raise ValueError("shuffle=True requires epoch(rng_tree, epoch) iteration")
            epoch_rng.shuffle(order)
        nproc, pid = self._shard_info()
        if nproc > 1:
            gbs = self.batch_size * nproc
            if len(order) < gbs:
                raise ValueError(
                    f"host-sharded loader: dataset has {len(order)} samples "
                    f"but one global batch needs batch_size * process_count "
                    f"= {self.batch_size} * {nproc} = {gbs}; shrink the "
                    f"batch or the process count")
            return [
                order[i + pid * self.batch_size:
                      i + (pid + 1) * self.batch_size].tolist()
                for i in range(0, len(order) - gbs + 1, gbs)
            ]
        batches = [
            order[i : i + self.batch_size].tolist()
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def epoch(
        self, rng_tree: RngTree | None = None, epoch: int = 0,
        skip: int = 0,
    ) -> Iterator[dict[str, np.ndarray]]:
        """Yield this epoch's batches; augmentation RNG is derived per sample.

        ``skip``: drop the first ``skip`` batches WITHOUT decoding them —
        step-granular preemption resume replays exactly the interrupted
        epoch's remaining batches (the epoch order is a pure function of
        (root seed, epoch) and each sample's augment RNG is derived from
        its global index, so the tail is bitwise the same batches the
        uninterrupted run would have seen)."""
        shuffle_rng = rng_tree.numpy_generator("shuffle", epoch) if rng_tree else None
        batches = self._batch_indices(shuffle_rng)
        if skip:
            batches = batches[skip:]

        def load(i: int) -> Mapping[str, Any]:
            rng = rng_tree.numpy_generator("data", epoch, i) if rng_tree else None
            return self.dataset.__getitem__(i, rng=rng)

        if self.num_workers <= 0:
            for batch in batches:
                yield self.collate_fn([load(i) for i in batch])
            return

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []
            batch_iter = iter(batches)
            # Keep up to `prefetch` batches in flight.
            for _ in range(self.prefetch):
                b = next(batch_iter, None)
                if b is None:
                    break
                pending.append([pool.submit(load, i) for i in b])
            while pending:
                futures = pending.pop(0)
                b = next(batch_iter, None)
                if b is not None:
                    pending.append([pool.submit(load, i) for i in b])
                yield self.collate_fn([f.result() for f in futures])

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        """Deterministic-order, augmentation-free iteration (valid/test)."""
        return self.epoch(None, 0)
