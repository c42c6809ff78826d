"""Checkpoints, metadata and the metrics stream of the trainers."""
