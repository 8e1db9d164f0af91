"""Continuous-batching serving of the port: block pool, scheduler, engine,
live recalibration."""
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.paged_cache import BlockPool
from repro_torch.serve.recalibrate import (RecalibPolicy, RecalibWorker,
                                           TrafficCalibrator)
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["BlockPool", "ContinuousEngine", "RecalibPolicy", "RecalibWorker",
           "Request", "Scheduler", "TrafficCalibrator"]
