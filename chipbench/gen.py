"""The one traffic generator: it reads a mix's parameters from
`traffic/<name>.json` and makes the requests of a run from `--seed`.

Every seed gets the same multiset of sizes, in another order: the sizes of
one round are fixed by the mix (a distribution's quantiles, or a list of
values each taken equally often), and the seed shuffles each round.  So
two seeds differ in order and in token ids, not in the work they ask for.
"""
from __future__ import annotations

import math
import statistics

import numpy as np
import torch


def round_lengths(lengths: dict, n: int) -> list[int]:
    """The `n` prompt lengths of one round, in ascending order."""
    dist = lengths["dist"]
    if dist == "choice":
        values = lengths["values"]
        if n % len(values):
            raise ValueError(f"a round of {n} does not take each of "
                             f"{len(values)} values equally often")
        return sorted(values * (n // len(values)))
    if dist == "lognormal":
        mult = lengths.get("multiple", 1)
        law = statistics.NormalDist(math.log(lengths["median"]),
                                    lengths["sigma"])
        out = []
        for i in range(n):
            x = math.exp(law.inv_cdf((i + 0.5) / n))
            x = mult * math.ceil(x / mult)
            out.append(int(min(lengths["max"], max(lengths["min"], x))))
        return out
    raise ValueError(f"unknown length distribution {dist!r}")


class Prompts:
    """The prompts of a closed loop: request i has `lengths[i]` tokens,
    uniform over the vocabulary, made on `device` from the seed.  Rounds
    are drawn as the loop reaches them (`ensure`), their tokens in one
    call each."""

    def __init__(self, traffic: dict, seed: int, vocab: int, device):
        self.traffic = traffic
        self.per_round = traffic["round"]
        self.base = round_lengths(traffic["lengths"], self.per_round)
        self.vocab = vocab
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed % (1 << 63))
        self.device = device
        self.lengths: list[int] = []
        self.starts: list[int] = []
        self.chunks: list[torch.Tensor] = []
        self._prio: list[np.ndarray] = []

    def ensure(self, n: int) -> None:
        """Draw rounds until request n - 1 exists."""
        while len(self.lengths) < n:
            order = self.rng.permutation(self.per_round)
            lens = [self.base[j] for j in order]
            toks = torch.randint(0, self.vocab, (sum(lens),),
                                 generator=self.gen, device=self.device,
                                 dtype=torch.int32)
            off = 0
            for L in lens:
                self.lengths.append(L)
                self.starts.append(off)
                self.chunks.append(toks)
                off += L

    def tokens(self, i: int) -> torch.Tensor:
        """Request i's prompt as a (1, L) int32 view."""
        self.ensure(i + 1)
        s, L = self.starts[i], self.lengths[i]
        return self.chunks[i][s:s + L][None]

    def priority(self, i: int) -> float:
        """Request i's place in the check's draw, a number from the seed
        (one generator a round, so it never depends on how far a run
        got)."""
        r, j = divmod(i, self.per_round)
        while len(self._prio) <= r:
            rng = np.random.default_rng([self.seed, 7, len(self._prio)])
            self._prio.append(rng.random(self.per_round))
        return float(self._prio[r][j])

    def sample(self, n: int) -> list[int]:
        """The requests that a run which finished the first n checks:
        the `traffic["sample"]` of least priority, a uniform draw from
        all of them (the harness adds the longest)."""
        return sorted(sorted(range(n), key=self.priority)[
            :self.traffic["sample"]])
