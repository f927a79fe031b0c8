"""GossipGraD core of the port: topologies, buckets, stacked-replica gossip
engines and protocols (port of ``repro/core``)."""
from .buckets import (LANE, BucketLayout, LeafSlot, PackedParams,
                      build_layout)
from .gossip import (exchange, make_packed_fused_update,
                     make_packed_gossip_mix, packed_fused_local_update)
from .protocols import PROTOCOLS, Protocol, make_protocol, make_ring_shuffle
from .topology import (GossipSchedule, build_schedule, dissemination_partner,
                       hypercube_partner, log2_steps)

__all__ = ["LANE", "BucketLayout", "LeafSlot", "PackedParams", "build_layout",
           "exchange", "make_packed_fused_update", "make_packed_gossip_mix",
           "packed_fused_local_update", "PROTOCOLS", "Protocol",
           "make_protocol", "make_ring_shuffle", "GossipSchedule",
           "build_schedule", "dissemination_partner", "hypercube_partner",
           "log2_steps"]
