"""Deterministic sharded data pipeline.

The port's copy of ``repro.data.pipeline``: for the same ``(seed, step,
shard)`` a batch's tokens and targets equal the reference's bitwise.  For
the ``audio`` and ``vlm`` families a batch also carries the modality stubs,
keyed as the reference keys them: ``embeds`` (b, S, d) in place of
``tokens`` (audio; ``multimodal.frame_embeddings``) and ``prefix_embeds``
(b, P, d) (vlm; ``multimodal.patch_embeddings``), each drawn from a CPU
``torch.Generator`` seeded with the reference's key.  Their values are the
port's own (jax's threefry stream is not reproduced) and equal run to run;
they are float32 numpy arrays holding values of the config's
``compute_dtype``, so that ``embed_inputs``' cast is exact.

Production posture without external deps: a synthetic-corpus tokenizer-free
source (seeded Zipf mixture with Markov structure so the LM loss actually
falls), document packing into fixed-length sequences with next-token
targets, deterministic *restartable* iteration (step -> batch is a pure
function of (seed, step) — resuming from a checkpoint replays the exact
stream with no state files), and per-host sharding (each data-parallel
host materializes only its slice — the multi-host pattern).

A background prefetch thread hides generation latency behind the train
step (the paper's copy/compute overlap at the input layer).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.models import multimodal
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32_000
    seq_len: int = 1024
    global_batch: int = 8
    # synthetic corpus knobs
    zipf_a: float = 1.2
    markov_order: int = 1
    n_states: int = 64
    doc_len_mean: int = 512


class SyntheticCorpus:
    """Seeded Markov-Zipf token source: documents with learnable structure.

    Each Markov state owns a Zipf-permuted slice of the vocab; transitions
    are sparse.  A 1-layer model reaches ~2-3 nats on this stream, so
    convergence tests have signal (pure-uniform streams don't train).
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v, s = cfg.vocab_size, cfg.n_states
        # per-state emission: Zipf weights over a state-specific permutation
        ranks = np.arange(1, v + 1, dtype=np.float64) ** (-cfg.zipf_a)
        self.emit_p = ranks / ranks.sum()
        self.perms = np.stack([rng.permutation(v) for _ in range(s)])
        # sparse transitions: each state -> 4 successors
        self.next_states = rng.integers(0, s, size=(s, 4))

    def document(self, doc_id: int) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed, 1, doc_id))
        length = max(16, int(rng.exponential(self.cfg.doc_len_mean)))
        state = int(rng.integers(self.cfg.n_states))
        out = np.empty((length,), np.int32)
        # vectorized-ish: emit in chunks per state run
        i = 0
        while i < length:
            run = int(rng.integers(8, 64))
            n = min(run, length - i)
            toks = rng.choice(self.cfg.vocab_size, size=n, p=self.emit_p)
            out[i:i + n] = self.perms[state][toks]
            i += n
            state = int(self.next_states[state, rng.integers(4)])
        return out


class PackedLMDataset:
    """Deterministic (seed, step, shard) -> batch packing.

    ``batch(step, shard_idx, num_shards)`` returns that host's slice of the
    global batch: dict(tokens (b,S) int32, targets (b,S) int32).  Document
    boundaries insert target masking (-1) for the first token of each doc.
    """

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig | None = None):
        self.cfg = cfg
        self.corpus = SyntheticCorpus(cfg)
        self.model_cfg = model_cfg

    def _sequence(self, seq_id: int) -> tuple[np.ndarray, np.ndarray]:
        """Pack documents into one (seq_len+1,) stream, then split x/y."""
        need = self.cfg.seq_len + 1
        rng = np.random.default_rng((self.cfg.seed, 2, seq_id))
        doc_id = int(rng.integers(2 ** 31)) + seq_id * 1000
        toks, bounds = [], []
        total = 0
        while total < need:
            d = self.corpus.document(doc_id)
            bounds.append(total)
            toks.append(d)
            total += len(d)
            doc_id += 1
        stream = np.concatenate(toks)[:need]
        x = stream[:-1].astype(np.int32)
        y = stream[1:].astype(np.int32).copy()
        for b in bounds:  # no cross-document prediction
            if 0 <= b - 1 < self.cfg.seq_len:
                y[b - 1] = -1
        return x, y

    def batch(self, step: int, shard_idx: int = 0, num_shards: int = 1) -> dict:
        gb = self.cfg.global_batch
        assert gb % num_shards == 0
        b = gb // num_shards
        xs, ys = [], []
        for i in range(b):
            seq_id = step * gb + shard_idx * b + i
            x, y = self._sequence(seq_id)
            xs.append(x)
            ys.append(y)
        out = {"tokens": np.stack(xs), "targets": np.stack(ys)}
        mc = self.model_cfg
        if mc is not None and mc.family == "audio":
            gen = _generator(hash((self.cfg.seed, step, shard_idx)))
            out["embeds"] = multimodal.frame_embeddings(
                gen, mc, b, self.cfg.seq_len).float().numpy()
            del out["tokens"]
        if mc is not None and mc.family == "vlm":
            gen = _generator(hash((self.cfg.seed, 3, step, shard_idx)))
            out["prefix_embeds"] = multimodal.patch_embeddings(
                gen, mc, b).float().numpy()
        return out

    def iterate(self, start_step: int = 0, shard_idx: int = 0,
                num_shards: int = 1) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step, shard_idx, num_shards)
            step += 1


def _generator(key: int) -> torch.Generator:
    """A CPU generator seeded as the reference seeds its PRNG key."""
    return torch.Generator().manual_seed(key % (2 ** 31))


class Prefetcher:
    """Background-thread prefetch (depth-N queue) over a batch iterator.

    ``close`` returns once the thread has stopped: a batch that the thread
    is still drawing with torch when the interpreter exits (the stub
    embeddings of the audio and vlm families) aborts the process."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self._q.put(item)
            if not self._stop.is_set():
                self._q.put(None)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        while self._t.is_alive():
            try:                           # free a put the thread waits on
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._t.join(timeout=0.05)
