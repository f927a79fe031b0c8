"""Gossip communication topologies (GossipGraD §4.3-4.5), numpy only.

Port of ``repro/core/topology.py`` (``GossipSchedule``, ``build_schedule``,
``dissemination_partner``, ``hypercube_partner``, ``log2_steps``), kept bit-exact with it: the same partner maps, the same
seeded rotations (``np.random.default_rng(seed).permutation``), the same
``recv_from`` tables.

* dissemination (§4.4.2): at sub-step k rank i sends to ``(i + 2^k) % p``;
* hypercube (§4.4.1): partner ``i XOR 2^k`` (p a power of two);
* rotation (§4.5.1): after every ``log2 p`` steps the rank space is
  relabelled by a pre-computed random permutation sigma_r, giving the map
  ``i -> sigma_r^{-1}((sigma_r(i) + 2^k) % p)``.

``BucketSubsetSchedule`` (partition-sampled wire) waits for the wire slice.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["GossipSchedule", "build_schedule", "dissemination_partner",
           "hypercube_partner", "log2_steps"]


def _check_p(p: int) -> None:
    if p < 2:
        raise ValueError(f"gossip needs p >= 2 ranks, got {p}")


def log2_steps(p: int) -> int:
    """Number of sub-steps per round: ceil(log2 p)."""
    return max(1, math.ceil(math.log2(p)))


def dissemination_partner(p: int, k: int) -> np.ndarray:
    """send_to[i] = (i + 2^k) % p  (GossipGraD §4.4.2)."""
    _check_p(p)
    shift = pow(2, k % log2_steps(p))
    return (np.arange(p) + shift) % p


def hypercube_partner(p: int, k: int) -> np.ndarray:
    """send_to[i] = i XOR 2^k (requires p a power of two, §4.4.1)."""
    _check_p(p)
    if p & (p - 1):
        raise ValueError(f"hypercube topology requires power-of-two p, got {p}")
    mask = pow(2, k % log2_steps(p))
    return np.arange(p) ^ mask


_TOPOLOGIES = {
    "dissemination": dissemination_partner,
    "hypercube": hypercube_partner,
}


def _apply_rotation(partner: np.ndarray, sigma: np.ndarray) -> np.ndarray:
    """Effective map i -> sigma^{-1}(partner(sigma(i)))."""
    inv = np.empty_like(sigma)
    inv[sigma] = np.arange(len(sigma))
    return inv[partner[sigma]]


@dataclasses.dataclass(frozen=True)
class GossipSchedule:
    """Pre-computed static gossip schedule: row t of ``perms`` is the
    send-to permutation of training step ``t mod period``."""

    p: int
    topology: str
    num_rotations: int
    substeps: int
    perms: np.ndarray  # (num_rotations * substeps, p)

    @property
    def period(self) -> int:
        return self.perms.shape[0]

    def send_to(self, step: int) -> np.ndarray:
        return self.perms[step % self.period]

    def recv_from(self, step: int) -> np.ndarray:
        s = self.send_to(step)
        inv = np.empty_like(s)
        inv[s] = np.arange(self.p)
        return inv


def build_schedule(p: int, topology: str = "dissemination",
                   num_rotations: int = 2, seed: int = 0) -> GossipSchedule:
    """``num_rotations`` random relabelings of the base topology, each used
    for ``log2(p)`` consecutive steps (§4.5.1)."""
    _check_p(p)
    if topology not in _TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}; options "
                         f"{sorted(_TOPOLOGIES)}")
    fn = _TOPOLOGIES[topology]
    substeps = log2_steps(p)
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(num_rotations):
        sigma = np.arange(p) if r == 0 else rng.permutation(p)
        for k in range(substeps):
            rows.append(_apply_rotation(fn(p, k), sigma))
    perms = np.stack(rows)
    for t, row in enumerate(perms):  # balanced communication (§4.3)
        if len(np.unique(row)) != p:
            raise AssertionError(f"schedule row {t} is not a permutation")
    return GossipSchedule(p=p, topology=topology, num_rotations=num_rotations,
                          substeps=substeps, perms=perms)
