"""Deterministic token pipeline for the LM architectures (the port's own
copy of ``repro.data.tokens``; numpy only, so ``batch_at`` and
``shard_for`` give the reference's arrays bit for bit).

Stateless skip-ahead: batch(step) is a pure function of (seed, step), so a
restarted job replays the exact stream from its checkpointed step. The
synthetic stream is a mixture of Zipf-distributed unigrams and short
repeated motifs (a learnable signal, so training losses fall).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    batch: int            # global batch (callers shard it over hosts)
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 8
    n_motifs: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._motifs = rng.integers(
            1, self.vocab_size, size=(self.n_motifs, self.motif_len))

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Returns {tokens, targets}: (B, L) int32 each; targets are
        next-token shifted with -1 padding on the final position."""
        rng = np.random.default_rng((self.seed << 20) ^ step)
        base = rng.zipf(self.zipf_a, size=(self.batch, self.seq_len + 1))
        toks = np.minimum(base, self.vocab_size - 1).astype(np.int32)
        # overwrite random spans with motifs (predictable structure)
        n_spans = max(1, self.seq_len // (4 * self.motif_len))
        for b in range(self.batch):
            ids = rng.integers(0, self.n_motifs, size=n_spans)
            starts = rng.integers(0, self.seq_len - self.motif_len,
                                  size=n_spans)
            for m, s in zip(ids, starts):
                toks[b, s: s + self.motif_len] = self._motifs[m]
        return {"tokens": toks[:, :-1],
                "targets": toks[:, 1:].astype(np.int32)}

    def shard_for(self, step: int, host_id: int, n_hosts: int):
        """Per-host slice of the global batch (multi-host data loading)."""
        full = self.batch_at(step)
        per = self.batch // n_hosts
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in full.items()}
