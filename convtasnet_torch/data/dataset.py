"""Segmented training / full-utterance datasets and a prefetching loader.

Copies of the JAX package's host pipeline (convtasnet_tpu/data/dataset.py,
numpy only), which reproduces the reference's (data.py:32-299):

* length-sorted bucketing (desc) over manifest entries;
* segment mode: utterances shorter than the segment are dropped; each
  utterance contributes ceil(len / segment) segments toward batch_size,
  an oversized first utterance is skipped (data.py:79-83); loading chops
  non-overlapping windows plus a tail window [-segment:], so every item is
  exactly segment_len samples;
* full-utterance mode (segment < 0): batches of batch_size, skipping
  utterances longer than cv_maxlen, zero-padded to the batch max or to a
  multiple (pad_to_multiple);
* the loader decodes on a thread pool ahead of the consumer; with shuffle
  the order is a pure function of (seed, epoch), which mid-epoch resume
  relies on.

AudioDataset decodes through the native C++ batch decoder
(data/native_loader.py) when it is available; a file at another rate, or a
machine without a toolchain, goes through the port's wavio. `counts()`
says how many files each decoder decoded since `reset_counts()`."""

from __future__ import annotations

import concurrent.futures as futures
import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .manifest import load_manifest
from .wavio import read_wav

# Files decoded by each decoder since reset_counts() (DataLoader threads
# decode concurrently, so updates take the lock).
_COUNTS = {"native": 0, "wavio": 0}
_COUNTS_LOCK = threading.Lock()


def counts() -> dict:
    """Files decoded by the native decoder and by wavio since the last
    reset_counts()."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_counts() -> None:
    with _COUNTS_LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0


def _count(decoder: str, n: int) -> None:
    with _COUNTS_LOCK:
        _COUNTS[decoder] += n


class Batch:
    """One training/eval batch: mixture [B, T], lengths [B], sources [B, C, T]."""

    __slots__ = ("mixture", "lengths", "source", "filenames", "__weakref__")

    def __init__(self, mixture, lengths, source=None, filenames=None):
        self.mixture = mixture
        self.lengths = lengths
        self.source = source
        self.filenames = filenames


def _sorted_infos(json_dir: str, speakers: Sequence[str]):
    infos = {s: load_manifest(os.path.join(json_dir, s + ".json")) for s in speakers}
    order = sorted(range(len(infos["mix"])), key=lambda i: int(infos["mix"][i][1]),
                   reverse=True)
    return {s: [v[i] for i in order] for s, v in infos.items()}


class AudioDataset:
    """Minibatch plan over a manifest directory (mix.json + s1..sC.json).
    Set `disable_native` on an instance to decode through wavio alone."""

    disable_native = False

    def __init__(self, json_dir: str, batch_size: int, sample_rate: int = 8000,
                 segment: float = 4.0, cv_maxlen: float = 8.0, num_speakers: int = 2,
                 pad_to_multiple: int = 1):
        self.sample_rate = sample_rate
        self.num_speakers = num_speakers
        self.pad_to_multiple = pad_to_multiple
        self.segment_len = int(segment * sample_rate) if segment >= 0 else -1
        speakers = ["mix"] + [f"s{i + 1}" for i in range(num_speakers)]
        infos = _sorted_infos(json_dir, speakers)
        mix = infos["mix"]

        batches: List[List[int]] = []
        if self.segment_len > 0:
            seg = self.segment_len
            self.num_dropped = sum(1 for _, n in mix if int(n) < seg)
            start = 0
            while start < len(mix):
                num_segments = 0
                end = start
                idxs: List[int] = []
                while num_segments < batch_size and end < len(mix):
                    utt_len = int(mix[end][1])
                    if utt_len >= seg:
                        num_segments += -(-utt_len // seg)
                        if num_segments > batch_size:
                            # An oversized first utterance is skipped outright.
                            if start == end:
                                end += 1
                            break
                        idxs.append(end)
                    end += 1
                if idxs:
                    batches.append(idxs)
                if end == len(mix):
                    break
                start = end
        else:
            self.num_dropped = 0
            maxlen = cv_maxlen * sample_rate
            start = 0
            while start < len(mix):
                end = min(len(mix), start + batch_size)
                if int(mix[start][1]) > maxlen:
                    start = end
                    continue
                batches.append(list(range(start, end)))
                if end == len(mix):
                    break
                start = end
        self.infos = infos
        self.speakers = speakers
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def _decode_utts(self, idxs):
        """Decode every file of the given utterances -> {(speaker, j): [T]}.

        The native C++ thread-pool decoder takes the batch when it is
        available; a file whose rate differs from the target is read again
        through wavio (which resamples), as is the whole batch when the
        native decode fails."""
        sr = self.sample_rate
        jobs = [(s, j) for j in idxs for s in self.speakers]
        out = {}
        if not self.disable_native:
            from . import native_loader

            if native_loader.available():
                paths = [self.infos[s][j][0] for s, j in jobs]
                max_len = max(int(self.infos[s][j][1]) for s, j in jobs)
                try:
                    buf, lens, rates = native_loader.decode_batch(paths, max_len)
                    for k, (s, j) in enumerate(jobs):
                        if int(rates[k]) == sr:
                            out[(s, j)] = buf[k, :int(lens[k])]
                except RuntimeError:
                    out = {}
        _count("native", len(out))
        rest = [(s, j) for s, j in jobs if (s, j) not in out]
        for s, j in rest:
            out[(s, j)], _ = read_wav(self.infos[s][j][0], sample_rate=sr)
        _count("wavio", len(rest))
        return out

    def load_batch(self, i: int) -> Batch:
        """Decode one planned minibatch into padded numpy arrays."""
        mixtures: List[np.ndarray] = []
        sources: List[np.ndarray] = []
        idxs = self.batches[i]
        for j in idxs:
            mix_path, n = self.infos["mix"][j]
            for s in self.speakers[1:]:
                if int(self.infos[s][j][1]) != int(n):
                    raise ValueError(f"length mismatch in manifests for {mix_path}")
        decoded = self._decode_utts(idxs)
        for j in idxs:
            mix = decoded[("mix", j)]
            srcs = np.stack([decoded[(s, j)] for s in self.speakers[1:]], axis=1)  # [T, C]
            T = mix.shape[0]
            seg = self.segment_len
            if seg > 0:
                for k in range(0, T - seg + 1, seg):
                    mixtures.append(mix[k:k + seg])
                    sources.append(srcs[k:k + seg])
                if T % seg != 0:
                    mixtures.append(mix[-seg:])
                    sources.append(srcs[-seg:])
            else:
                mixtures.append(mix)
                sources.append(srcs)
        lengths = np.array([m.shape[0] for m in mixtures], dtype=np.int32)
        maxT = int(lengths.max())
        if self.pad_to_multiple > 1:
            maxT = -(-maxT // self.pad_to_multiple) * self.pad_to_multiple
        mix_pad = np.zeros((len(mixtures), maxT), np.float32)
        src_pad = np.zeros((len(mixtures), self.num_speakers, maxT), np.float32)
        for b in range(len(mixtures)):
            mix_pad[b, :lengths[b]] = mixtures[b]
            src_pad[b, :, :lengths[b]] = sources[b].T
        return Batch(mix_pad, lengths, src_pad)


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
    """Threaded prefetching iterator over an AudioDataset / EvalDataset:
    batches decode on a thread pool, up to `prefetch` ahead of the
    consumer."""

    def __init__(self, dataset, shuffle: bool = False, num_workers: int = 2,
                 prefetch: int = 2, seed: int = 0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self._epoch = 0
        self._seed = seed

    def __len__(self):
        return len(self.dataset)

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle epoch, so the order is a pure function of
        (seed, epoch) (the hook mid-epoch resume relies on)."""
        self._epoch = epoch

    def __iter__(self) -> Iterator[Batch]:
        return self.iter_from(0)

    def iter_from(self, skip: int) -> Iterator[Batch]:
        """Iterate, dropping the first `skip` planned batches without
        decoding them (mid-epoch resume)."""
        order = list(range(len(self.dataset)))
        if self.shuffle:
            np.random.default_rng(self._seed + self._epoch).shuffle(order)
        order = order[skip:]
        self._epoch += 1
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
