"""Deterministic, sharded, checkpointable synthetic data pipeline.

The port's own copy of ``repro.data.pipeline`` (numpy only, so the port
imports nothing of the JAX package): for the same seed, shard and step
its batches are bitwise the JAX package's.

Every batch is a pure function of ``(seed, step, shard)`` via counter-based
RNG, so:

* restart at step k reproduces exactly the stream a continuous run saw
  (checkpoint stores only the integer ``step``),
* each data shard (host) draws a disjoint slice with no coordination,
* elastic rescale re-partitions cleanly: shard assignment depends only on
  ``(step, shard_index, n_shards)``.

Two generators:
* ``uniform``  — i.i.d. tokens (for shape/throughput benchmarks),
* ``markov``   — tokens from a fixed random first-order Markov chain; its
  conditional entropy is well below log(V), so a model trained on it shows
  a real, verifiable loss drop (used by ``CompiledPlan.train`` and the
  training tests).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "markov"        # "markov" | "uniform"
    branching: int = 4           # markov: successors per state


def markov_transition(vocab: int, branching: int, seed: int) -> np.ndarray:
    """(vocab, branching) successor table of a sparse random Markov chain."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC311]))
    return rng.integers(0, vocab, size=(vocab, branching), dtype=np.int32)


class SyntheticLMData:
    """Iterator over (inputs, labels) int32 arrays of shape (local_B, S)."""

    def __init__(self, config: DataConfig, shard: int = 0, n_shards: int = 1,
                 start_step: int = 0):
        assert config.global_batch % n_shards == 0, (config, n_shards)
        self.config = config
        self.shard = shard
        self.n_shards = n_shards
        self.local_batch = config.global_batch // n_shards
        self.step = start_step
        if config.kind == "markov":
            self._table = markov_transition(config.vocab, config.branching,
                                            config.seed)

    # -- checkpointable state ------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.config.seed,
                "kind": self.config.kind}

    def load_state_dict(self, state: dict) -> None:
        assert state["seed"] == self.config.seed, "seed mismatch on restore"
        self.step = int(state["step"])

    def reshard(self, shard: int, n_shards: int) -> "SyntheticLMData":
        """Elastic re-partition at the current step."""
        return SyntheticLMData(self.config, shard, n_shards, self.step)

    # -- generation -------------------------------------------------------
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            [self.config.seed, step, self.shard, self.n_shards]))

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.config
        rng = self._rng(step)
        B, S = self.local_batch, cfg.seq_len
        if cfg.kind == "uniform":
            seq = rng.integers(0, cfg.vocab, size=(B, S + 1), dtype=np.int32)
        else:
            seq = np.empty((B, S + 1), np.int32)
            seq[:, 0] = rng.integers(0, cfg.vocab, size=B)
            choices = rng.integers(0, cfg.branching, size=(B, S))
            for t in range(1, S + 1):
                seq[:, t] = self._table[seq[:, t - 1], choices[:, t - 1]]
        return seq[:, :-1].copy(), seq[:, 1:].copy()

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        batch = self.batch_at(self.step)
        self.step += 1
        return batch

    def entropy_floor(self) -> float:
        """Conditional entropy of the markov source (nats) — the loss floor."""
        if self.config.kind == "uniform":
            return float(np.log(self.config.vocab))
        # successors drawn uniformly from `branching` slots (with possible
        # duplicates): entropy <= log(branching)
        return float(np.log(self.config.branching))
