"""Fault-tolerance runtime (the port of ``repro.runtime``)."""
