"""Filelist dataset and length-bucketed batching for training.

The port's own copy of ``personalized_text_to_speech_tpu/data/dataset.py``
(reference ``data_utils.py:16-276``): ``path|sid|text`` filelists, text-length
filtering (1–190), spectrogram length estimated from the file size, and an
epoch-seeded, rank-sharded bucket sampler.  As in the JAX package, items carry only
``(text_ids, wav, sid)`` (the spectrogram is computed on the device inside the
train step), and batches are padded to static bucket shapes: text to the next
of ``text_pad_to``, audio to the bucket's upper frame boundary × hop.  Fixed
shapes let cuDNN and cuBLAS reuse their plans from step to step.  In a
data-parallel run each process iterates its rank's shard: every rank has the
same number of batches and takes the buckets in the same order.
"""

from __future__ import annotations

import os
import queue
import random
import threading
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from personalized_text_to_speech_tpu_torch import text as text_frontend
from personalized_text_to_speech_tpu_torch.data.audio import load_wav_mono


def parse_filelist(path: str, split: str = "|") -> List[List[str]]:
    """Read ``path|sid|text`` lines (reference ``utils.py:290-293``)."""
    with open(path, encoding="utf-8") as f:
        return [line.strip().split(split) for line in f if line.strip()]


@dataclass
class DatasetConfig:
    sampling_rate: int = 22050
    hop_length: int = 256
    cleaned_text: bool = True
    text_cleaners: Sequence[str] = ("cjke_cleaners2",)
    add_blank: bool = True
    min_text_len: int = 1
    max_text_len: int = 190

    @classmethod
    def from_hparams(cls, hps) -> "DatasetConfig":
        return cls(
            sampling_rate=hps.data.sampling_rate,
            hop_length=hps.data.hop_length,
            cleaned_text=hps.data.get("cleaned_text", False),
            text_cleaners=tuple(hps.data.text_cleaners),
            add_blank=hps.data.add_blank,
        )


class TextAudioSpeakerDataset:
    """Filelist-backed dataset of (text_ids, wav, sid) items
    (reference ``TextAudioSpeakerLoader``, ``data_utils.py:16-112``)."""

    def __init__(self, filelist_path: str, cfg: DatasetConfig, symbols,
                 seed: int = 1234):
        self.cfg = cfg
        self.symbols = list(symbols)
        entries = parse_filelist(filelist_path)
        random.Random(seed).shuffle(entries)
        self.entries: List[Tuple[str, int, str]] = []
        self.lengths: List[int] = []  # estimated spec frames, for bucketing
        for row in entries:
            if len(row) != 3:
                continue
            audiopath, sid, text = row
            if not (cfg.min_text_len <= len(text) <= cfg.max_text_len):
                continue
            self.entries.append((audiopath, int(sid), text))
            try:
                # wav_len ≈ file_size / 2 bytes; frames = wav_len / hop
                # (reference data_utils.py:59)
                est = os.path.getsize(audiopath) // (2 * cfg.hop_length)
            except OSError:
                est = 400
            self.lengths.append(est)

    def __len__(self) -> int:
        return len(self.entries)

    def get_text_ids(self, text: str) -> np.ndarray:
        if self.cfg.cleaned_text:
            seq = text_frontend.cleaned_text_to_sequence(text, self.symbols)
        else:
            seq = text_frontend.text_to_sequence(
                text, self.symbols, self.cfg.text_cleaners
            )
        if self.cfg.add_blank:
            seq = text_frontend.intersperse(seq, 0)
        return np.asarray(seq, dtype=np.int32)

    def __getitem__(self, index: int):
        audiopath, sid, text = self.entries[index]
        wav = load_wav_mono(audiopath, self.cfg.sampling_rate)
        return {
            "text": self.get_text_ids(text),
            "wav": wav.astype(np.float32),
            "sid": sid,
        }


class BucketBatcher:
    """Epoch-seeded, length-bucketed, rank-sharded batch iterator (reference
    ``DistributedBucketSampler``, ``data_utils.py:170-276``) that pads every
    batch to its bucket's static shapes.

    Every bucket is padded to a multiple of ``shard_count × batch_size``
    (its own ids repeated), and after the epoch's shuffle shard
    ``shard_index`` takes ids ``shard_index::shard_count``: each shard holds
    the same number of batches of each bucket, and the final shuffle of the
    batches, seeded by the epoch alone, orders the buckets alike on every
    rank.  A rank that ran one step more than the others would wait in its
    collectives for ever."""

    def __init__(
        self,
        dataset: TextAudioSpeakerDataset,
        batch_size: int,
        boundaries: Sequence[int] = (32, 300, 400, 500, 600, 700, 800, 900, 1000),
        text_pad_to: Sequence[int] = (64, 128, 192, 256, 384),
        shard_index: int = 0,
        shard_count: int = 1,
        shuffle: bool = True,
        seed: int = 1234,
    ):
        if not 0 <= shard_index < shard_count:
            raise ValueError(
                f"shard_index {shard_index} outside shard_count {shard_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.text_pad_to = list(text_pad_to)
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

        self.buckets: List[List[int]] = [[] for _ in range(len(self.boundaries) - 1)]
        for i, length in enumerate(dataset.lengths):
            b = self._bisect(length)
            if b != -1:
                self.buckets[b].append(i)
        # drop empty buckets (and their upper boundary), like the reference
        for i in range(len(self.buckets) - 1, -1, -1):
            if not self.buckets[i]:
                self.buckets.pop(i)
                self.boundaries.pop(i + 1)
        total = shard_count * batch_size
        self.num_samples_per_bucket = [
            len(bucket) + (total - len(bucket) % total) % total
            for bucket in self.buckets
        ]

    def _bisect(self, x: int) -> int:
        for i in range(len(self.boundaries) - 1):
            if self.boundaries[i] < x <= self.boundaries[i + 1]:
                return i
        return -1

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return sum(self.num_samples_per_bucket) // (
            self.shard_count * self.batch_size)

    def _text_cap(self, n: int) -> int:
        for b in self.text_pad_to:
            if n <= b:
                return b
        return self.text_pad_to[-1]

    def batch_indices(self) -> List[Tuple[int, List[int]]]:
        rng = random.Random(self.seed + self.epoch)
        batches: List[Tuple[int, List[int]]] = []
        for bi, bucket in enumerate(self.buckets):
            ids = list(range(len(bucket)))
            if self.shuffle:
                rng.shuffle(ids)
            rem = self.num_samples_per_bucket[bi] - len(bucket)
            if rem > 0:
                ids = ids + (ids * (rem // len(bucket))) + ids[: rem % len(bucket)]
            ids = ids[self.shard_index :: self.shard_count]
            for j in range(len(ids) // self.batch_size):
                chunk = ids[j * self.batch_size : (j + 1) * self.batch_size]
                batches.append((bi, [bucket[k] for k in chunk]))
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def iter_prefetch(self, depth: int = 2) -> Iterator[dict]:
        """Iterate with a background thread that decodes and pads the next
        batches while the device runs the current step."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        sentinel = object()
        err: list = []

        def producer():
            try:
                for batch in self:
                    q.put(batch)
            except Exception as e:  # handed to the consumer, raised there
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if err:
            raise err[0]

    def __iter__(self) -> Iterator[dict]:
        hop = self.dataset.cfg.hop_length
        for bucket_idx, idxs in self.batch_indices():
            items = [self.dataset[i] for i in idxs]
            max_samples = self.boundaries[bucket_idx + 1] * hop
            text_cap = self._text_cap(max(len(it["text"]) for it in items))

            b = len(items)
            text = np.zeros((b, text_cap), dtype=np.int32)
            text_lengths = np.zeros(b, dtype=np.int32)
            wav = np.zeros((b, max_samples), dtype=np.float32)
            wav_lengths = np.zeros(b, dtype=np.int32)
            sid = np.zeros(b, dtype=np.int32)
            for i, it in enumerate(items):
                t = it["text"][:text_cap]
                text[i, : len(t)] = t
                text_lengths[i] = len(t)
                w = it["wav"][:max_samples]
                # whole hops only, so frames = samples / hop exactly
                n = (len(w) // hop) * hop
                wav[i, :n] = w[:n]
                wav_lengths[i] = n
                sid[i] = it["sid"]
            yield {
                "text": text,
                "text_lengths": text_lengths,
                "wav": wav,
                "wav_lengths": wav_lengths,
                "sid": sid,
            }
