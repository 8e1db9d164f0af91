"""Continuous-batching serving of the port: block pool, scheduler, engine."""
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.paged_cache import BlockPool
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["BlockPool", "ContinuousEngine", "Request", "Scheduler"]
