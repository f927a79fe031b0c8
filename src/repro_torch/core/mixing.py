"""Gossip mixing-matrix analysis (GossipGraD §6), numpy only.

Port of ``repro/core/mixing.py``. One gossip step replaces rank j's weights
by ``(w_j + w_{c(j)}) / 2`` with ``c = recv_from`` the step's partner map:
stacked over ranks, ``W' = M W`` with ``M = (I + P_c) / 2``.

* M is doubly stochastic, so the mean of the parameters is preserved;
* the product of a round's matrices contracts the disagreement subspace,
  and for the dissemination schedule at a power-of-two p it averages
  exactly after ceil(log2 p) steps, the fixed point of one all-reduce.
"""
from __future__ import annotations

import numpy as np

from .topology import GossipSchedule

__all__ = ["mixing_matrix", "round_matrix", "is_doubly_stochastic",
           "consensus_contraction", "spectral_gap"]


def mixing_matrix(recv_from: np.ndarray) -> np.ndarray:
    """M = (I + P)/2 for one gossip step given recv_from[i] = partner of i."""
    p = len(recv_from)
    m = np.eye(p)
    m[np.arange(p), recv_from] += 1.0
    return m / 2.0


def round_matrix(schedule: GossipSchedule, start: int = 0,
                 steps: int | None = None) -> np.ndarray:
    """Product of the mixing matrices of ``steps`` consecutive steps (one
    round of ``schedule.substeps`` by default)."""
    if steps is None:
        steps = schedule.substeps
    m = np.eye(schedule.p)
    for t in range(start, start + steps):
        m = mixing_matrix(schedule.recv_from(t)) @ m
    return m


def is_doubly_stochastic(m: np.ndarray, atol: float = 1e-12) -> bool:
    return (bool(np.all(m >= -atol))
            and np.allclose(m.sum(0), 1.0, atol=atol)
            and np.allclose(m.sum(1), 1.0, atol=atol))


def consensus_contraction(m: np.ndarray) -> float:
    """Operator norm of M on the disagreement subspace 1^perp: below 1 the
    step contracts disagreement, 0 is exact averaging."""
    p = m.shape[0]
    proj = np.eye(p) - np.ones((p, p)) / p
    return float(np.linalg.norm(proj @ m @ proj, ord=2))


def spectral_gap(m: np.ndarray) -> float:
    """1 - contraction factor; larger is faster diffusion."""
    return 1.0 - consensus_contraction(m)
