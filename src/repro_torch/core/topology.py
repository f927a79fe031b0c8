"""Gossip communication topologies (GossipGraD §4.3-4.5), numpy only.

Port of ``repro/core/topology.py`` (``GossipSchedule``, ``build_schedule``,
``dissemination_partner``, ``hypercube_partner``, ``ring_partner``,
``log2_steps``, ``reachability``, ``diffusion_steps``), kept bit-exact with
it: the same partner maps, the same seeded rotations
(``np.random.default_rng(seed).permutation``), the same ``recv_from``
tables.

* dissemination (§4.4.2): at sub-step k rank i sends to ``(i + 2^k) % p``;
* hypercube (§4.4.1): partner ``i XOR 2^k`` (p a power of two);
* ring (§4.5.2): rank i sends to ``(i + 1) % p``, one sub-step a rotation;
* rotation (§4.5.1): after every ``log2 p`` steps the rank space is
  relabelled by a pre-computed random permutation sigma_r, giving the map
  ``i -> sigma_r^{-1}((sigma_r(i) + 2^k) % p)``.

``BucketSubsetSchedule`` and ``build_subset_schedule`` (the
partition-sampled wire's rotating bucket subset) are bit-exact ports too.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["GossipSchedule", "build_schedule", "dissemination_partner",
           "hypercube_partner", "ring_partner", "log2_steps",
           "BucketSubsetSchedule", "build_subset_schedule", "reachability",
           "diffusion_steps"]


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


def ring_partner(p: int, k: int = 0) -> np.ndarray:
    """send_to[i] = (i + 1) % p — the sample shuffle's ring (§4.5.2)."""
    _check_p(p)
    del k
    return (np.arange(p) + 1) % p


_TOPOLOGIES = {
    "dissemination": dissemination_partner,
    "hypercube": hypercube_partner,
    "ring": ring_partner,
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
    for ``log2(p)`` consecutive steps (one step for ``"ring"``, §4.5.1)."""
    _check_p(p)
    if topology not in _TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}; options "
                         f"{sorted(_TOPOLOGIES)}")
    fn = _TOPOLOGIES[topology]
    substeps = 1 if topology == "ring" else log2_steps(p)
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


@dataclasses.dataclass(frozen=True)
class BucketSubsetSchedule:
    """Rotating bucket subset of the partition-sampled wire: at exchange
    ``t`` the ``n_send`` buckets of the window starting at ``(t % period) *
    n_send`` (mod ``num_buckets``) are sent, so every bucket goes out at
    least once per ``period`` exchanges. ``t`` may be negative (floor-mod,
    as the reference's ``selected`` and ``mask``)."""

    num_buckets: int
    n_send: int

    def __post_init__(self):
        if not (1 <= self.n_send < self.num_buckets):
            raise ValueError(
                f"subset schedule needs 1 <= n_send < num_buckets, got "
                f"n_send={self.n_send}, num_buckets={self.num_buckets} "
                "(full participation needs no schedule: pass None)")

    @property
    def period(self) -> int:
        return -(-self.num_buckets // self.n_send)

    @property
    def fraction(self) -> float:
        return self.n_send / self.num_buckets

    def selected(self, t: int) -> np.ndarray:
        """Bool mask (num_buckets,) of the buckets sent at exchange t."""
        start = (int(t) % self.period) * self.n_send
        idx = (np.arange(self.num_buckets) - start) % self.num_buckets
        return idx < self.n_send


def build_subset_schedule(num_buckets: int, fraction: float
                          ) -> BucketSubsetSchedule | None:
    """Subset schedule sending ``ceil(fraction * num_buckets)`` buckets per
    exchange; None (full participation) when that is every bucket."""
    if not (0.0 < fraction <= 1.0):
        raise ValueError(f"gossip subset fraction must be in (0, 1], "
                         f"got {fraction}")
    n_send = max(1, math.ceil(fraction * num_buckets - 1e-9))
    if n_send >= num_buckets:
        return None
    return BucketSubsetSchedule(num_buckets=num_buckets, n_send=n_send)


def reachability(schedule: GossipSchedule, steps: int) -> np.ndarray:
    """Bool (p, p): has rank j's information reached rank i within
    ``steps`` gossip steps (directly or through others)? After a step rank
    i holds its own state mixed with ``recv_from[i]``'s."""
    reach = np.eye(schedule.p, dtype=bool)
    for t in range(steps):
        reach = reach | reach[schedule.recv_from(t)]
    return reach


def diffusion_steps(schedule: GossipSchedule, max_steps: int = 64) -> int:
    """Fewest steps after which every rank has mixed with every other, or
    -1 within ``max_steps``; ceil(log2 p) for dissemination (§4.4)."""
    reach = np.eye(schedule.p, dtype=bool)
    for t in range(max_steps):
        reach = reach | reach[schedule.recv_from(t)]
        if reach.all():
            return t + 1
    return -1
