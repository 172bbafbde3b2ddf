"""Synthetic non-IID federated LM data with the pushift.io-Reddit shape.

The paper trains on pushift.io's Reddit (LEAF): millions of users, mean ~34
comments/user, power-law sample counts, naturally non-IID per-user language.
We reproduce the *statistics* (the carbon study depends on compute/comm
volume and client heterogeneity, not on lexical content):

* sample counts: Pareto-tail distribution, mean ≈ 34, deterministic per
  client id;
* per-user language: a global Zipf unigram-with-bigram-state generator mixed
  with a user-specific "dialect" (a preferred vocab slice + preferred bigram
  shift), giving natural label skew across clients;
* char-level view for the paper's char-CNN-LSTM: word id -> deterministic
  pseudo-word over a 26-letter alphabet with word-length ~ Zipf rank.

All generation is stateless + deterministic in (seed, client_id), so tens of
millions of "clients" exist without storing anything. This is the port's own
NumPy copy of the reference generator: for the same seed, client id and
batch size it gives equal arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

_MEAN_SAMPLES = 34.0
_PARETO_SHAPE = 1.8      # heavy tail like comment counts


def client_num_samples(client_id: int, seed: int = 0,
                       mean: float = _MEAN_SAMPLES) -> int:
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + client_id))
    # numpy's pareto is Lomax: E[x] = 1/(shape-1), so scale = mean*(shape-1)
    scale = mean * (_PARETO_SHAPE - 1)
    n = int(rng.pareto(_PARETO_SHAPE) * scale + 1)
    return max(2, min(n, 4096))


@dataclasses.dataclass
class FederatedDataset:
    """Deterministic synthetic federated corpus."""

    vocab_size: int
    seq_len: int
    num_clients: int = 1_000_000
    seed: int = 0
    dialect_frac: float = 0.35      # prob of drawing from the user dialect
    dialect_size: int = 512         # size of each user's preferred slice
    char_vocab: int = 0             # >0: also emit char decomposition
    max_word_len: int = 16

    # ---------------------------------------------------------- word level
    def _zipf_probs(self, n: int) -> np.ndarray:
        ranks = np.arange(1, n + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        return p / p.sum()

    def client_tokens(self, client_id: int, n_samples: Optional[int] = None
                      ) -> np.ndarray:
        """(n, seq_len) int32 token ids for one client."""
        if n_samples is None:
            n_samples = client_num_samples(client_id, self.seed)
        rng = np.random.default_rng(
            np.uint64(self.seed * 7_777_777 + client_id * 13 + 1))
        V = self.vocab_size
        n_zipf = min(V, 4096)
        probs = self._zipf_probs(n_zipf)
        # user dialect: a contiguous slice + offset keyed by the client
        d_start = int(rng.integers(0, max(1, V - self.dialect_size)))
        shift = int(rng.integers(0, V))
        total = n_samples * self.seq_len
        base = rng.choice(n_zipf, size=total, p=probs)
        # weak bigram structure: odd positions correlate with previous token
        prev = np.roll(base, 1)
        bigram_mask = rng.random(total) < 0.3
        base = np.where(bigram_mask, (prev + shift) % n_zipf, base)
        use_dialect = rng.random(total) < self.dialect_frac
        dialect = d_start + (base % self.dialect_size)
        toks = np.where(use_dialect, dialect, base).astype(np.int32) % V
        return toks.reshape(n_samples, self.seq_len)

    # ---------------------------------------------------------- char level
    def word_chars(self, word_ids: np.ndarray) -> np.ndarray:
        """Deterministic pseudo-word spelling. word_ids: (...,) ->
        (..., max_word_len) int32 (0 = pad, ids 1..char_vocab-1)."""
        assert self.char_vocab > 0
        flat = word_ids.reshape(-1).astype(np.int64)
        W = self.max_word_len
        # word length grows ~log(rank): frequent words are short
        lens = np.clip(2 + (np.log1p(flat) * 1.7).astype(np.int64), 2, W)
        # char sequence via multiplicative hash chain
        out = np.zeros((flat.size, W), dtype=np.int32)
        state = flat * 2654435761 % (2 ** 31)
        nchars = min(self.char_vocab - 1, 26)
        for i in range(W):
            state = (state * 1103515245 + 12345) % (2 ** 31)
            out[:, i] = 1 + (state % nchars)
        mask = np.arange(W)[None, :] < lens[:, None]
        out = np.where(mask, out, 0)
        return out.reshape(word_ids.shape + (W,)).astype(np.int32)

    # ---------------------------------------------------------- batching
    def client_batches(self, client_id: int, batch_size: int,
                       local_epochs: int = 1) -> list:
        """List of batch dicts covering the client's data E times."""
        toks = self.client_tokens(client_id)
        n = toks.shape[0]
        batches = []
        for _ in range(local_epochs):
            for i in range(0, n, batch_size):
                chunk = toks[i: i + batch_size]
                if chunk.shape[0] < batch_size:  # pad + mask
                    pad = np.zeros((batch_size - chunk.shape[0], self.seq_len),
                                   np.int32)
                    mask = np.concatenate([
                        np.ones((chunk.shape[0], self.seq_len - 1), np.float32),
                        np.zeros((pad.shape[0], self.seq_len - 1), np.float32)])
                    chunk = np.concatenate([chunk, pad], axis=0)
                else:
                    mask = np.ones((batch_size, self.seq_len - 1), np.float32)
                batch = {"tokens": chunk, "labels": chunk,
                         "mask": mask}
                if self.char_vocab:
                    batch["chars"] = self.word_chars(chunk)
                batches.append(batch)
        return batches

    def eval_batch(self, n_clients: int, batch_size: int,
                   offset: int = 10_000_000) -> Dict[str, np.ndarray]:
        """Held-out eval batch from `n_clients` disjoint clients (the paper
        evaluates on 20 held-out clients)."""
        rows = []
        for c in range(n_clients):
            t = self.client_tokens(offset + c, n_samples=max(1, batch_size // n_clients))
            rows.append(t)
        toks = np.concatenate(rows, axis=0)[:batch_size]
        if toks.shape[0] < batch_size:
            reps = -(-batch_size // toks.shape[0])
            toks = np.tile(toks, (reps, 1))[:batch_size]
        batch = {"tokens": toks, "labels": toks,
                 "mask": np.ones((batch_size, self.seq_len - 1), np.float32)}
        if self.char_vocab:
            batch["chars"] = self.word_chars(toks)
        return batch
