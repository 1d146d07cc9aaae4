"""Deterministic synthetic data pipeline (a copy of
``repro/data/pipeline.py``, pure numpy: tokens and targets are bit-equal
to the reference's for any seed, index and sharding; the image prefix and
the conditioning come from seeds the reference's numpy refuses, see
``_PREFIX_STREAM``).

Design points that matter at scale:
  * **Elastic determinism** -- batch ``i`` of a run is a pure function of
    (seed, i, global_batch), never of host count or restart point, so
    elastic rescaling and checkpoint-restart see the identical stream.
  * **Shard-local generation** -- each data shard materialises only its
    slice (no host ever holds the global batch).
  * **Background prefetch** -- a depth-``prefetch`` thread queue overlaps
    host generation with device steps.

The stream is a mixture of repeated n-gram motifs (so small models can
overfit in a few hundred steps -- used by the quickstart example) plus
uniform noise.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig

IGNORE = -1
# The reference seeds a batch's image prefix with (seed, -1 - index) and
# its conditioning with (seed, -10_000 - index), which numpy refuses (a
# seed's entropy is non-negative), so its pipeline cannot make a batch for
# a prefix_len or cond_len config.  The port draws them from (seed, index,
# stream): three-word keys, apart from the rows' (seed, row) keys.
_PREFIX_STREAM, _COND_STREAM = 1, 2


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    motif_vocab_frac: float = 0.5   # motifs drawn from low token ids
    motif_len: int = 8
    noise_frac: float = 0.1
    prefetch: int = 2


def _gen_batch(cfg: DataConfig, model_cfg: ModelConfig, index: int,
               shard: int = 0, num_shards: int = 1) -> Dict[str, Any]:
    """Generate (this shard's slice of) batch `index` deterministically."""
    assert cfg.global_batch % num_shards == 0
    b_local = cfg.global_batch // num_shards
    v = model_cfg.vocab_size
    mv = max(4, int(v * cfg.motif_vocab_frac))
    out_tok = np.empty((b_local, cfg.seq_len), np.int32)
    for r in range(b_local):
        g = cfg.global_batch * index + shard * b_local + r
        rng = np.random.default_rng((cfg.seed, g))
        motif = rng.integers(0, mv, cfg.motif_len)
        reps = -(-cfg.seq_len // cfg.motif_len)
        row = np.tile(motif, reps)[: cfg.seq_len]
        noise = rng.random(cfg.seq_len) < cfg.noise_frac
        row[noise] = rng.integers(0, v, noise.sum())
        out_tok[r] = row
    targets = np.concatenate(
        [out_tok[:, 1:], np.full((b_local, 1), IGNORE, np.int32)], axis=1)
    batch = {"tokens": out_tok, "targets": targets}
    p = model_cfg.prefix_len or 0
    if p:
        rng = np.random.default_rng((cfg.seed, index, _PREFIX_STREAM))
        batch["extra_embeds"] = rng.standard_normal(
            (b_local, p, model_cfg.d_model)).astype(np.float32) * 0.02
        batch["targets"] = np.concatenate(
            [np.full((b_local, p), IGNORE, np.int32), targets], axis=1)
    if model_cfg.cond_len:
        rng = np.random.default_rng((cfg.seed, index, _COND_STREAM))
        batch["cond"] = rng.standard_normal(
            (b_local, model_cfg.cond_len,
             model_cfg.cond_dim or model_cfg.d_model)).astype(np.float32) * 0.02
    return batch


class DataPipeline:
    """Iterator with background prefetch; resumable via ``start_index``."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig,
                 shard: int = 0, num_shards: int = 1, start_index: int = 0):
        self.cfg, self.model_cfg = cfg, model_cfg
        self.shard, self.num_shards = shard, num_shards
        self.index = start_index
        self._q: queue.Queue = queue.Queue(maxsize=max(1, cfg.prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        i = self.index
        while not self._stop.is_set():
            b = _gen_batch(self.cfg, self.model_cfg, i, self.shard,
                           self.num_shards)
            while not self._stop.is_set():
                try:
                    self._q.put((i, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            i += 1

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self

    def __next__(self) -> Dict[str, Any]:
        i, b = self._q.get()
        self.index = i + 1
        return b

    def close(self):
        self._stop.set()


def batch_at(cfg: DataConfig, model_cfg: ModelConfig, index: int,
             shard: int = 0, num_shards: int = 1) -> Dict[str, Any]:
    """Pure accessor (no thread) -- used by tests and restarts."""
    return _gen_batch(cfg, model_cfg, index, shard, num_shards)
