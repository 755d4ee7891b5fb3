"""Continuous-batching serve engine over a paged KV cache (the port of
``repro/serving/``; docs/port.md, "Continuous batching and the int8
cache").

- :mod:`repro_torch.serving.pages` -- page-pool allocator + cache-tree
  paging
- :mod:`repro_torch.serving.scheduler` -- per-step admit/extend/preempt/
  retire
- :mod:`repro_torch.serving.engine` -- the engine driving the paged decode
  step
"""
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.pages import PagedKvAllocator, pages_for
from repro_torch.serving.scheduler import ContinuousScheduler, ServeRequest

__all__ = ["ContinuousBatchingEngine", "PagedKvAllocator",
           "ContinuousScheduler", "ServeRequest", "pages_for"]
