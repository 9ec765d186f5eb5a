"""Deterministic synthetic LM data: the port of ``repro.data.pipeline``.

Token streams are drawn from a fixed per-(step, shard) threefry key
through :mod:`repro_torch.core.prng`, so for the same seed and step the
tokens equal the JAX package's bit for bit, and runs of either package are
exactly reproducible.

Two flavours:
* ``iid``      — uniform tokens (throughput benchmarking);
* ``markov``   — per-agent biased bigram chains: each data shard (an
  "agent" in the paper's sense) drifts by its own step range, the LM
  analogue of the paper's non-IID local signals. The robust-training runs
  use it.

Tokens and labels are int64 (torch's index type); their values are the
reference's int32 values.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.plan import resolve_device
from ..core.prng import Key, fold_in, prng_key, randint_n

__all__ = ["SyntheticLMData", "make_batch_specs"]


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    vocab: int
    seq_len: int
    global_batch: int
    flavour: str = "iid"          # "iid" | "markov"
    n_agents: int = 1             # data-parallel worker count (markov bias)
    seed: int = 0

    def batch(self, step: int, device=None) -> dict[str, torch.Tensor]:
        """The global batch of ``step`` on ``device`` (``None``: the
        card)."""
        key = fold_in(prng_key(self.seed), step)
        toks = self._tokens(key, self.global_batch, 0, device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def shard_batch(self, step: int, agent: int, local_batch: int,
                    device=None) -> dict[str, torch.Tensor]:
        """Worker-local slice, drawn independently per (step, agent)."""
        key = fold_in(fold_in(prng_key(self.seed), step), agent)
        toks = self._tokens(key, local_batch, agent, device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _tokens(self, key: Key, batch: int, agent: int,
                device) -> torch.Tensor:
        dev = resolve_device(device)
        S = self.seq_len + 1
        if self.flavour == "iid":
            return randint_n(key, batch * S, 0, self.vocab, dev).reshape(
                batch, S)
        if self.flavour != "markov":
            raise ValueError(f"unknown flavour {self.flavour!r}")
        # markov: agent-specific drift, token_{t+1} = token_t + step_draw
        k1, k2 = fold_in(key, 0), fold_in(key, 1)     # jax.random.split
        start = randint_n(k1, batch, 0, self.vocab, dev).reshape(batch, 1)
        drift = 1 + (agent % 7)
        steps = randint_n(k2, batch * (S - 1), 0, 2 * drift + 1,
                          dev).reshape(batch, S - 1) - drift
        toks = torch.cumsum(torch.cat([start, steps], dim=1), dim=1)
        return torch.remainder(toks, self.vocab)


def make_batch_specs(seq_len: int, global_batch: int, vocab: int,
                     device="meta") -> dict[str, torch.Tensor]:
    """Stand-ins for one training batch, nothing drawn: ``tokens`` and
    ``labels`` (global_batch, seq_len) int64 (the reference's int32
    ``ShapeDtypeStruct``s in the port's index type). On ``"meta"`` by
    default; under a ``FakeTensorMode`` on any device they are fake
    tensors (the dry run's)."""
    del vocab           # the reference's signature: a spec draws no values
    shape = (global_batch, seq_len)
    return {k: torch.empty(shape, dtype=torch.int64, device=device)
            for k in ("tokens", "labels")}
