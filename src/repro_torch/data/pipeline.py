"""Sharded token data pipeline over the Lustre substrate.

The training corpus is one big token file striped over all OSTs; every
data-parallel rank reads its own deterministic slice per step. Reads go
through the collaborative cache (COBD, §5.5) when caching nodes are
registered — the "cluster boots and everyone reads the same file" pattern
the paper built the COBD for. Determinism: (seed, epoch) -> a stable
permutation of sequence indices, sharded by rank, so restarts resume
exactly (the trainer checkpoints `step`).
"""
from __future__ import annotations

import numpy as np

from repro_torch.fsio.client import LustreClient


class TokenDataset:
    """Writer/creator for a token corpus file."""

    def __init__(self, fs: LustreClient, path: str = "/data/tokens.bin",
                 *, vocab: int = 32000, seq_len: int = 128,
                 n_seqs: int = 1024, seed: int = 0,
                 stripe_count: int = 0, stripe_size: int = 1 << 20):
        self.fs = fs
        self.path = path
        self.vocab = vocab
        self.seq_len = seq_len
        self.n_seqs = n_seqs
        self.seed = seed
        self.stripe_count = stripe_count
        self.stripe_size = stripe_size

    @property
    def seq_bytes(self) -> int:
        return self.seq_len * 4

    def build(self) -> "TokenDataset":
        """Generate + write the corpus (idempotent)."""
        if self.fs.exists(self.path):
            return self
        parent = "/".join(p for p in self.path.split("/")[:-1] if p)
        if parent:
            self.fs.mkdir_p(parent)
        rng = np.random.default_rng(self.seed)
        fh = self.fs.creat(self.path, stripe_count=self.stripe_count,
                           stripe_size=self.stripe_size)
        chunk = 256
        for start in range(0, self.n_seqs, chunk):
            n = min(chunk, self.n_seqs - start)
            toks = rng.integers(0, self.vocab, size=(n, self.seq_len),
                                dtype=np.int32)
            self.fs.write(fh, toks.tobytes(), offset=start * self.seq_bytes)
        self.fs.close(fh)
        return self


class TokenPipeline:
    """Deterministic per-rank batch iterator reading striped data."""

    def __init__(self, fs: LustreClient, ds: TokenDataset, *,
                 dp_rank: int, dp_size: int, batch_per_rank: int,
                 seed: int = 1234):
        self.fs = fs
        self.ds = ds
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.batch = batch_per_rank
        self.seed = seed
        self.fh = fs.open(ds.path, "r")
        self.per_epoch = ds.n_seqs // (dp_size * batch_per_rank)

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.ds.n_seqs)

    def indices_for(self, step: int) -> np.ndarray:
        epoch, within = divmod(step, self.per_epoch)
        perm = self._perm(epoch)
        base = within * self.dp_size * self.batch
        mine = perm[base + self.dp_rank * self.batch:
                    base + (self.dp_rank + 1) * self.batch]
        return np.sort(mine)

    def batch_at(self, step: int) -> np.ndarray:
        """(batch, seq_len) int32 tokens for this rank at `step`."""
        idx = self.indices_for(step)
        sb = self.ds.seq_bytes
        out = np.empty((self.batch, self.ds.seq_len), np.int32)
        # coalesce adjacent sequences into one striped read
        runs = []
        run_start = idx[0]
        prev = idx[0]
        for i in idx[1:]:
            if i != prev + 1:
                runs.append((run_start, prev))
                run_start = i
            prev = i
        runs.append((run_start, prev))
        row = 0
        for a, b in runs:
            data = self.fs.read(self.fh, (b - a + 1) * sb, offset=a * sb)
            arr = np.frombuffer(data, np.int32).reshape(-1, self.ds.seq_len)
            out[row:row + len(arr)] = arr
            row += len(arr)
        return out

    def close(self):
        self.fs.close(self.fh)
