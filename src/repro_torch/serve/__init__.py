"""Serving of the port: the fixed-batch and the continuous-batching engine,
block pool, scheduler, live recalibration."""
from repro_torch.serve.engine import ContinuousEngine, ServeEngine
from repro_torch.serve.paged_cache import BlockPool
from repro_torch.serve.recalibrate import (RecalibPolicy, RecalibWorker,
                                           TrafficCalibrator)
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["BlockPool", "ContinuousEngine", "RecalibPolicy", "RecalibWorker",
           "Request", "Scheduler", "ServeEngine", "TrafficCalibrator"]
