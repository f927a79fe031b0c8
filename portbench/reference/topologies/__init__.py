"""One module a gossip topology, named as the traffic file's
``bundle.topology`` names it: ``perms(p, rotations, seed)``, the send-to
rows of its schedule."""
