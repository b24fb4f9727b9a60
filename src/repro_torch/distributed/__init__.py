"""Sharded discovery engine (the reference's DESIGN.md §11), on PyTorch."""
from .sharded_engine import ShardedEngine, ShardedEngineState

__all__ = ["ShardedEngine", "ShardedEngineState"]
