"""Private-signal likelihood models for non-Bayesian social learning.

Each agent ``j`` observes a private signal from a finite alphabet whose
distribution ``l_j(. | theta*)`` depends on the unknown state; marginals may
be identical across hypotheses at one agent (local confusion) while the
joint distribution stays globally observable (Assumption 2).

A copy of ``repro.core.signals`` with the tables held as a float32 torch
tensor. :func:`make_confused_model` draws from the same numpy generator in
the same order as the reference, so it builds the same tables.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .prng import Key, split, uniform

__all__ = [
    "SignalModel",
    "make_confused_model",
    "check_global_observability",
    "pairwise_kl",
    "log_ratio_bound",
]


@dataclasses.dataclass(frozen=True)
class SignalModel:
    """Finite-alphabet signal structure for N agents, m hypotheses.

    tables: (N, m, S) float32 — ``tables[j, k, s] = l_j(s | theta_k)``.
    truth: index of theta* in [0, m).
    """

    tables: torch.Tensor
    truth: int

    @property
    def N(self) -> int:
        return int(self.tables.shape[0])

    @property
    def m(self) -> int:
        return int(self.tables.shape[1])

    @property
    def S(self) -> int:
        return int(self.tables.shape[2])

    def log_tables(self) -> torch.Tensor:
        return torch.log(self.tables)

    def sample(self, key: Key, t_steps: int = 1) -> torch.Tensor:
        """(t_steps, N) int32 signals drawn from l_j(. | theta*), on the
        tables' device: agent j's draws are ``jax.random.choice(split(key,
        N)[j], S, (t_steps,), p=l_j(. | theta*))`` bit for bit, the inverse
        CDF of a uniform, ``searchsorted(cumsum(p), cumsum(p)[-1] * (1 -
        u))``."""
        dev = self.tables.device
        cdf = torch.cumsum(self.tables[:, self.truth, :].float(), dim=-1)
        keys = split(key, self.N, dev)
        u = uniform(Key(keys.k0[:, None], keys.k1[:, None]), t_steps, dev)
        x = cdf[:, -1:] * (1.0 - u)                          # (N, t_steps)
        return torch.searchsorted(cdf, x).to(torch.int32).T

    def log_lik(self, signals: torch.Tensor) -> torch.Tensor:
        """signals: (N,) ints -> (N, m) log l_j(s_j | theta_k)."""
        logt = self.log_tables()
        idx = signals.long().reshape(-1, 1, 1).expand(-1, self.m, 1)
        return torch.gather(logt, 2, idx)[:, :, 0]


def pairwise_kl(tables: np.ndarray) -> np.ndarray:
    """(N, m, m) per-agent KL(l_j(.|theta_a) || l_j(.|theta_b))."""
    t = np.asarray(tables, dtype=np.float64)
    logt = np.log(t)
    self_term = np.einsum("nas,nas->na", t, logt)
    cross_term = np.einsum("nas,nbs->nab", t, logt)
    return self_term[:, :, None] - cross_term


def check_global_observability(tables: np.ndarray, tol: float = 1e-9) -> bool:
    """Assumption 2: for every pair theta != theta', sum_j KL_j > 0."""
    total = pairwise_kl(np.asarray(tables)).sum(axis=0)
    m = total.shape[0]
    return bool((total[~np.eye(m, dtype=bool)] > tol).all())


def log_ratio_bound(tables: np.ndarray) -> float:
    """The paper's constant L = sup_{s, theta, theta'} log l(s|t)/l(s|t')."""
    logt = np.log(np.asarray(tables, dtype=np.float64))
    diff = logt[:, :, None, :] - logt[:, None, :, :]
    return float(diff.max())


def make_confused_model(
    N: int,
    m: int,
    S: int = 4,
    truth: int = 0,
    confusion: float = 0.75,
    sharpness: float = 2.0,
    seed: int = 0,
) -> SignalModel:
    """A locally confused but globally observable signal model.

    Agent j is informative only about hypothesis ``j % m``; a ``confusion``
    fraction of agents is made completely uninformative, keeping at least
    one informative agent per hypothesis. Needs N >= m.
    """
    if N < m:
        raise ValueError("need N >= m for global observability by construction")
    rng = np.random.default_rng(seed)
    base = rng.dirichlet(np.ones(S) * sharpness, size=(N,))
    tables = np.repeat(base[:, None, :], m, axis=1)

    n_uninformative = int(confusion * N)
    informative = np.ones(N, dtype=bool)
    disable = rng.permutation(N)[:n_uninformative]
    informative[disable] = False
    for k in range(m):
        if not informative[k::m].any():
            informative[k] = True   # the first agent j with j % m == k

    for j in np.nonzero(informative)[0]:
        distinct = rng.dirichlet(np.ones(S) * sharpness)
        while np.abs(distinct - base[j]).sum() < 0.2:
            distinct = rng.dirichlet(np.ones(S) * sharpness)
        tables[j, j % m, :] = distinct

    tables = np.maximum(tables, 0.02)
    tables = tables / tables.sum(axis=-1, keepdims=True)
    if not check_global_observability(tables):
        raise AssertionError("construction must satisfy Assumption 2")
    return SignalModel(tables=torch.tensor(tables, dtype=torch.float32),
                       truth=truth)
