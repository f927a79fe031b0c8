"""Roofline terms of one step on H100 nodes, and the exchange's bytes.

Port of ``repro/launch/roofline.py`` (``Hardware``, ``roofline_terms``),
retargeted from a TPU v5e mesh to H100 SXM5 nodes of 8 GPUs:

    compute term    = FLOPs_per_chip / peak_FLOPs
    memory term     = op_bytes_per_chip / HBM_bw
    collective term = max(net_bytes_per_chip / cross-node bw,
                          nvlink_bytes_per_chip / NVLink bw)

The reference reads the collectives from the compiled HLO
(``collective_bytes``: payloads of every all-gather, all-reduce, ...,
scaled by loop trip counts). The port has no compiled program to read;
``exchange_bytes`` fills the same record keys from what the port's rank
path sends in one step (``core/gossip.py: exchange`` and
``replica_mean``, the ring shuffle, and inside a replica the stretches'
all-gather and the gradient's reduce-scatter of ``core/buckets.py``),
reckoned on the host. The collective
term charges the exchange between replicas at the cross-node rate: gossip
partners, and the replicas of a mean, sit on other nodes (every ``data``
neighbour of the production mesh is on another node, ``launch/mesh.py``).
The in-replica bytes are split by the link they cross
(``in_replica_bytes``): what comes from the ranks of the chip's own node
at the NVLink rate, the rest at the cross-node rate; the two links run at
once, so the term is the larger of the two times. This is a model, as the
reference's wire weights are.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.buckets import BucketLayout
from repro_torch.core.gossip import gossip_bytes_per_step, wire_bytes_per_step
from repro_torch.kernels.quantize import WireFormat

__all__ = ["Hardware", "H100", "NODE", "COLLECTIVES", "exchange_bytes",
           "in_replica_bytes", "roofline_terms"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float     # per GPU, dense bf16
    hbm_bw: float         # bytes/s per GPU
    net_bw: float         # bytes/s per GPU per direction across nodes
    nvlink_bw: float      # bytes/s per GPU per direction inside a node


# Datasheet figures of the H100 SXM5 80 GB (none measured here): 989 TFLOP/s
# dense bf16 on the tensor cores; 3.35 TB/s of HBM3; 50 GB/s per GPU per
# direction across nodes (InfiniBand NDR, 400 Gb/s, one NIC a GPU); 450 GB/s
# per GPU per direction of NVLink 4 inside a node.
H100 = Hardware(name="h100-sxm5-80gb (datasheet)", peak_flops=989e12,
                hbm_bw=3.35e12, net_bw=50e9, nvlink_bw=450e9)

NODE = 8   # GPUs a node, joined all to all by NVLink

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# wire-cost multiplier per payload byte (the reference's: ring algorithms in
# the large-message limit)
_WIRE_WEIGHT = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}


def in_replica_bytes(shards: int, batch_shards: int, replica_bytes: float,
                     grad_bytes: float, node: int = NODE) -> Dict:
    """Per-chip bytes one rank receives per train step from the other ranks
    of its replica (``core/buckets.py``): the forward's all-gather of the
    ``shards - 1`` other stretches of every bucket, ``(shards - 1) /
    shards`` of the replica bytes, and the backward's reduce-scatter, an
    ``all_to_all`` in which the ``batch_shards - 1`` other ranks of its
    batch group each send their chunk of the rank's stretch,
    ``(batch_shards - 1) / shards`` of the gradient bytes.

    ``net_bytes`` and ``nvlink_bytes`` split them by link. A replica's
    shards are consecutive ranks, ``g = min(shards, node)`` of them on a
    node of ``node`` GPUs. A stretch from another node is wanted by all
    ``g`` ranks of the replica there, so it crosses the network once a
    node: ``(shards - g) / shards / g`` of the replica bytes a chip; the
    rest of the all-gather moves over NVLink. The batch group's members
    are ``shards / batch_shards`` ranks apart, and each sends the rank a
    chunk of its own: the chunks from members on other nodes cross the
    network."""
    shards = max(int(shards), 1)
    batch = max(int(batch_shards), 1)
    g = min(shards, node)
    apart = shards // batch
    on_node = min(batch, max(node // apart, 1)) if apart < node else 1
    gather = replica_bytes * (shards - 1) / shards
    gather_net = replica_bytes * (shards - g) / shards / g
    scatter = grad_bytes * (batch - 1) / shards
    scatter_net = grad_bytes * (batch - on_node) / shards
    return {"all-gather_bytes": gather, "reduce-scatter_bytes": scatter,
            "shards": shards, "batch_shards": batch,
            "net_bytes": gather_net + scatter_net,
            "nvlink_bytes": gather - gather_net + scatter - scatter_net}


def exchange_bytes(protocol: Optional[str], dp: int, model_shards: int,
                   replica_bytes: float, grad_bytes: float,
                   batch_bytes: float, wire: WireFormat | None = None,
                   layout: BucketLayout | None = None,
                   batch_shards: int = 1) -> Dict:
    """Per-chip bytes of one step's exchange between replicas, in the
    reference's record keys (``{op}_bytes``, ``{op}_count``,
    ``wire_bytes``), from what the port's rank path sends:

    * ``gossip`` / ``gossip_async``: one collective-permute of the chip's
      shard of its replica (``gossip_bytes_per_step``; with a ``layout``,
      ``wire_bytes_per_step(layout, wire)["total_bytes"]``, codes and
      scales of the sent subset), and the ring shuffle's collective-permute
      of the chip's ``batch_bytes``;
    * ``agd`` (the gradient mean) and ``every_logp`` (the parameter mean,
      on its averaging steps): an all-gather of the other ``dp - 1``
      replicas' shards, which ``core/gossip.py: replica_mean`` sums in rank
      order (bit-exact with the stacked mean);
    * ``none``, ``None`` (serving) or ``dp <= 1``: nothing.

    ``allreduce_equivalent_bytes`` is ``2·shard·(dp-1)/dp``, the
    reference's all-reduce lowering of the same mean, so the paper's
    comparison stays readable. A train step (``protocol`` given) over
    ``model_shards > 1`` in-replica shards also moves the in-pod FSDP
    collectives of one process per mesh position (``in_replica_bytes``,
    ``batch_shards`` of them splitting the replica's rows): they add to the
    all-gather and reduce-scatter keys, and ``in_replica_collectives``
    holds them apart. ``net_bytes`` and ``nvlink_bytes`` are what the
    collective term charges at each rate: the exchange between replicas
    and the in-replica bytes from other nodes cross the network."""
    payload = {k: 0.0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    shards = max(int(model_shards), 1)
    shard = (grad_bytes if protocol == "agd" else replica_bytes) / shards
    if protocol in ("gossip", "gossip_async") and dp > 1:
        if layout is not None:
            sent = wire_bytes_per_step(layout, wire)["total_bytes"]
        else:
            sent = gossip_bytes_per_step(replica_bytes, dp,
                                         shards)["gossip_bytes_per_chip"]
        payload["collective-permute"] = sent + float(batch_bytes)
        counts["collective-permute"] = 2
    elif protocol in ("agd", "every_logp") and dp > 1:
        payload["all-gather"] = shard * (dp - 1)
        counts["all-gather"] = 1
    elif protocol not in (None, "none", "gossip", "gossip_async", "agd",
                          "every_logp"):
        raise ValueError(f"unknown protocol {protocol!r}")
    net = sum(_WIRE_WEIGHT[k] * v for k, v in payload.items())
    nvlink, inner = 0.0, None
    if protocol is not None and shards > 1:
        inner = in_replica_bytes(shards, batch_shards, replica_bytes,
                                 grad_bytes)
        for k in ("all-gather", "reduce-scatter"):
            if inner[f"{k}_bytes"]:
                payload[k] += inner[f"{k}_bytes"]
                counts[k] += 1
        net += inner["net_bytes"]
        nvlink = inner["nvlink_bytes"]
    out = {f"{k}_bytes": payload[k] for k in COLLECTIVES}
    out.update({f"{k}_count": counts[k] for k in COLLECTIVES})
    out["wire_bytes"] = sum(_WIRE_WEIGHT[k] * v for k, v in payload.items())
    out["net_bytes"], out["nvlink_bytes"] = net, nvlink
    out["allreduce_equivalent_bytes"] = (2.0 * shard * (dp - 1) / dp
                                         if dp > 1 and protocol else 0.0)
    out["in_replica_collectives"] = (
        inner if inner is not None else "none (one replica a chip)"
        if shards == 1 else "none counted (serving gathers its weights "
        "once, before its steps; a step's logits gather and expert-parallel "
        "sums are not modelled, ROADMAP B)")
    return out


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   net_bytes_per_chip: float, hw: Hardware = H100,
                   nvlink_bytes_per_chip: float = 0.0) -> Dict[str, float]:
    """The three terms in seconds and the largest (``dominant``); the
    collective term is the slower of the two links."""
    compute = flops_per_chip / hw.peak_flops
    memory = bytes_per_chip / hw.hbm_bw
    collective = max(net_bytes_per_chip / hw.net_bw,
                     nvlink_bytes_per_chip / hw.nvlink_bw)
    dominant = max((("compute", compute), ("memory", memory),
                    ("collective", collective)), key=lambda kv: kv[1])[0]
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective, "dominant": dominant}
