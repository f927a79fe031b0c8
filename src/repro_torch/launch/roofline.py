"""Roofline terms of one step on H100 nodes, and the exchange's bytes.

Port of ``repro/launch/roofline.py`` (``Hardware``, ``roofline_terms``),
retargeted from a TPU v5e mesh to H100 SXM5 nodes of 8 GPUs:

    compute term    = FLOPs_per_chip / peak_FLOPs
    memory term     = op_bytes_per_chip / HBM_bw
    collective term = wire_bytes_per_chip / cross-node bw

The reference reads the collectives from the compiled HLO
(``collective_bytes``: payloads of every all-gather, all-reduce, ...,
scaled by loop trip counts). The port has no compiled program to read;
``exchange_bytes`` fills the same record keys from what the port's rank
path sends in one step (``core/gossip.py: exchange`` and
``replica_mean``, the ring shuffle), reckoned on the host. The collective
term charges that exchange at the cross-node rate: gossip partners, and the
replicas of a mean, sit on other nodes (every ``data`` neighbour of the
production mesh is on another node, ``launch/mesh.py``). This is a
model, as the reference's wire weights are.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.buckets import BucketLayout
from repro_torch.core.gossip import gossip_bytes_per_step, wire_bytes_per_step
from repro_torch.kernels.quantize import WireFormat

__all__ = ["Hardware", "H100", "COLLECTIVES", "exchange_bytes",
           "roofline_terms"]


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

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# wire-cost multiplier per payload byte (the reference's: ring algorithms in
# the large-message limit)
_WIRE_WEIGHT = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}


def exchange_bytes(protocol: Optional[str], dp: int, model_shards: int,
                   replica_bytes: float, grad_bytes: float,
                   batch_bytes: float, wire: WireFormat | None = None,
                   layout: BucketLayout | None = None) -> Dict:
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
    comparison stays readable. Collectives inside a replica (TP / FSDP
    over the ``model`` and ``data`` axes) are not modeled until in-pod
    FSDP is ported; ``in_replica_collectives`` says so."""
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
    out = {f"{k}_bytes": payload[k] for k in COLLECTIVES}
    out.update({f"{k}_count": counts[k] for k in COLLECTIVES})
    out["wire_bytes"] = sum(_WIRE_WEIGHT[k] * v for k, v in payload.items())
    out["allreduce_equivalent_bytes"] = (2.0 * shard * (dp - 1) / dp
                                         if dp > 1 and protocol else 0.0)
    out["in_replica_collectives"] = (
        "not modeled (ROADMAP A.12b)" if shards > 1
        else "none (one replica a chip)")
    return out


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   wire_bytes_per_chip: float,
                   hw: Hardware = H100) -> Dict[str, float]:
    """The three terms in seconds and the largest (``dominant``)."""
    compute = flops_per_chip / hw.peak_flops
    memory = bytes_per_chip / hw.hbm_bw
    collective = wire_bytes_per_chip / hw.net_bw
    dominant = max((("compute", compute), ("memory", memory),
                    ("collective", collective)), key=lambda kv: kv[1])[0]
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective, "dominant": dominant}
