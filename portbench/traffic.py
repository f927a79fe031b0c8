"""The one generator of training traffic: a traffic file's parameters to a
ring of distinct token batches on the device, made from the seed during
set-up. ``tokens.source`` "bigram": every row starts at a uniform token and
follows a random successor table, ``branching`` successors a token (the
structure of ``repro_torch.data.synthetic``'s bigram task, drawn here on
the device)."""
from __future__ import annotations

import torch

_GOLDEN = 0x9E3779B97F4A7C15


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed per (run seed, stream): weights, tokens."""
    return (int(seed) * _GOLDEN + stream * 0xBF58476D1CE4E5B9) % (1 << 63)


def replicas(job) -> int:
    return int(job["bundle"]["dp"])


def tokens_per_step(job) -> int:
    """Every replica's tokens of one step."""
    return replicas(job) * int(job["rows"]) * int(job["seq_len"])


def make_ring(job, vocab: int, seed: int, device) -> torch.Tensor:
    """(ring, dp, rows, seq_len + 1) int64 tokens: batch i of the ring feeds
    step i (mod ring); every row differs."""
    src = job["tokens"]
    if src["source"] != "bigram":
        raise ValueError(f"unknown token source {src['source']!r}")
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 2))
    shape = (int(job["ring"]), replicas(job), int(job["rows"]))
    n, S = shape[0] * shape[1] * shape[2], int(job["seq_len"])
    br = int(src["branching"])
    table = torch.randint(0, vocab, (vocab, br), generator=gen, device=device)
    choice = torch.randint(0, br, (n, S), generator=gen, device=device)
    x = torch.empty((n, S + 1), dtype=torch.int64, device=device)
    x[:, 0] = torch.randint(0, vocab, (n,), generator=gen, device=device)
    for t in range(S):
        x[:, t + 1] = table[x[:, t], choice[:, t]]
    return x.view(shape + (S + 1,))
