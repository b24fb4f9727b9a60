"""Durable engine checkpoints (the port of ``repro.checkpoint``)."""
