"""GossipGraD core of the port: topologies and their mixing matrices,
buckets, stacked-replica gossip engines, the async ring and protocols
(port of ``repro/core``)."""
from .async_gossip import (exchange_ok, init_inbox_ring, init_wire_inbox_ring,
                           make_packed_async_gossip_mix,
                           make_packed_fused_async_update)
from .buckets import (LANE, BucketLayout, LeafSlot, PackedParams,
                      build_layout)
from .gossip import (exchange, make_packed_fused_update,
                     make_packed_gossip_mix, packed_fused_local_update,
                     wire_period, wire_subset_of)
from .mixing import (consensus_contraction, is_doubly_stochastic,
                     mixing_matrix, round_matrix, spectral_gap)
from .protocols import PROTOCOLS, Protocol, make_protocol, make_ring_shuffle
from .topology import (BucketSubsetSchedule, GossipSchedule, build_schedule,
                       build_subset_schedule, diffusion_steps,
                       dissemination_partner, hypercube_partner, log2_steps,
                       reachability, ring_partner)

__all__ = ["LANE", "BucketLayout", "LeafSlot", "PackedParams", "build_layout",
           "exchange", "make_packed_fused_update", "make_packed_gossip_mix",
           "packed_fused_local_update", "wire_period", "wire_subset_of",
           "exchange_ok", "init_inbox_ring", "init_wire_inbox_ring",
           "make_packed_async_gossip_mix", "make_packed_fused_async_update",
           "PROTOCOLS", "Protocol", "make_protocol", "make_ring_shuffle",
           "BucketSubsetSchedule", "GossipSchedule", "build_schedule",
           "build_subset_schedule", "dissemination_partner",
           "hypercube_partner", "ring_partner", "log2_steps", "reachability",
           "diffusion_steps", "mixing_matrix", "round_matrix",
           "is_doubly_stochastic", "consensus_contraction", "spectral_gap"]
