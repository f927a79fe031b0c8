"""Runnable examples of the port (port of the reference's ``examples/``):
``python -m repro_torch.examples.{quickstart,gossip_vs_agd,serve_batched}``.
Each takes ``--device`` (default cuda, which raises without a card) and
exposes ``main(argv) -> dict``."""
