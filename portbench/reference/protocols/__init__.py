"""One module a GossipGraD protocol, named as the traffic file's
``bundle.protocol`` names it. Each has ``Protocol(ref)``, whose
``begin(ref, t)`` returns the mix of step ``t`` (``mix(i, r, p32)``: bucket
``i`` of replica ``r`` mixed in float32, or None where nothing is mixed)
and whose ``end(ref, t)`` closes the step; ``partner_bytes(job, step,
sizes, item)``, the partner bytes an element of each bucket that the
fused sweep of ``step`` reads; and ``checked_payloads(job, num_buckets,
seed)``, the buckets whose wire payloads of dispatch 0 the comparison
reads (none without a coded wire)."""
