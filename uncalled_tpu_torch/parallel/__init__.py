"""Multi-device execution layouts of the port.

- data-parallel replicated index: one engine per card, no collective.
- sharded FM-index for large references over ``torch.distributed``:
  :mod:`.sharded`.
"""

from .sharded import ShardedMapEngine, ShardedPooledEngine

__all__ = ["ShardedMapEngine", "ShardedPooledEngine"]
