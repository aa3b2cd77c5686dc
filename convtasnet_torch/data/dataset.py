"""Mixture-only inference dataset and a prefetching loader.

Copies of the JAX package's host pipeline pieces that the separate path
uses (numpy only): length-sorted full-utterance batches, zero-padded to
the batch max or to a multiple (pad_to_multiple), decoded on a thread pool
ahead of the consumer. The segmenting training dataset and the native
decoder come with the training slice."""

from __future__ import annotations

import concurrent.futures as futures
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from .manifest import load_manifest
from .wavio import read_wav


class Batch:
    """One training/eval batch: mixture [B, T], lengths [B], sources [B, C, T]."""

    __slots__ = ("mixture", "lengths", "source", "filenames", "__weakref__")

    def __init__(self, mixture, lengths, source=None, filenames=None):
        self.mixture = mixture
        self.lengths = lengths
        self.source = source
        self.filenames = filenames


class EvalDataset:
    """Mixture-only dataset for inference (data.py:162-199). Accepts a
    directory of wavs (manifested on the fly) or an existing mix.json."""

    def __init__(self, mix_dir: Optional[str] = None, mix_json: Optional[str] = None,
                 batch_size: int = 1, sample_rate: int = 8000,
                 pad_to_multiple: int = 1):
        if mix_dir is None and mix_json is None:
            raise ValueError("EvalDataset needs mix_dir or mix_json")
        self.pad_to_multiple = pad_to_multiple
        if mix_dir is not None:
            from .manifest import preprocess_one_dir

            mix_json = preprocess_one_dir(mix_dir, mix_dir, "mix", sample_rate)
        infos = sorted(load_manifest(mix_json), key=lambda e: int(e[1]), reverse=True)
        self.infos = infos
        self.sample_rate = sample_rate
        self.batches = [
            list(range(s, min(len(infos), s + batch_size)))
            for s in range(0, len(infos), batch_size)
        ]

    def __len__(self):
        return len(self.batches)

    def load_batch(self, i: int) -> Batch:
        idxs = self.batches[i]
        mixtures, names = [], []
        for j in idxs:
            path, _ = self.infos[j]
            x, _ = read_wav(path, sample_rate=self.sample_rate)
            mixtures.append(x)
            names.append(path)
        lengths = np.array([m.shape[0] for m in mixtures], dtype=np.int32)
        maxT = int(lengths.max())
        if self.pad_to_multiple > 1:
            # Bound the number of distinct compiled shapes: without this,
            # batch_size=1 inference compiles once PER UTTERANCE length.
            maxT = -(-maxT // self.pad_to_multiple) * self.pad_to_multiple
        mix_pad = np.zeros((len(mixtures), maxT), np.float32)
        for b, m in enumerate(mixtures):
            mix_pad[b, : lengths[b]] = m
        return Batch(mix_pad, lengths, filenames=names)


class DataLoader:
    """Threaded prefetching iterator over an EvalDataset: batches decode on
    a thread pool, up to `prefetch` ahead of the consumer."""

    def __init__(self, dataset, num_workers: int = 2, prefetch: int = 2):
        self.dataset = dataset
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)

    def __len__(self):
        return len(self.dataset)

    def __iter__(self) -> Iterator[Batch]:
        order = list(range(len(self.dataset)))
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with futures.ThreadPoolExecutor(self.num_workers) as pool:
                pending = [pool.submit(self.dataset.load_batch, i) for i in order[: self.prefetch + 1]]
                next_submit = self.prefetch + 1
                for k in range(len(order)):
                    if stop.is_set():
                        for p in pending:
                            if p is not None:
                                p.cancel()
                        return
                    try:
                        q.put(pending[k].result())
                    except Exception as e:  # surface loader errors to consumer
                        q.put(e)
                        return
                    # Release the completed future: a Future keeps its result
                    # (a decoded, padded batch) alive.
                    pending[k] = None
                    if next_submit < len(order):
                        pending.append(pool.submit(self.dataset.load_batch, order[next_submit]))
                        next_submit += 1
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
