"""Observability of the port (counterpart of ``repro/obs``): tracing,
metrics, numerics monitors and the flight recorder.

  * :mod:`repro_torch.obs.trace` — Chrome/Perfetto ``trace_event`` spans
    around the serving and recalibration hot paths (``--trace-out``);
  * :mod:`repro_torch.obs.metrics` — Counter/Gauge/Histogram registry
    behind ``ContinuousEngine.metrics()``, Prometheus text and JSON
    snapshots (``--metrics-out``);
  * :mod:`repro_torch.obs.numerics` — per-layer R-factor conditioning and
    residual-vs-bound checks (the live recalibration gates);
  * :mod:`repro_torch.obs.flight` — bounded per-request flight recorder and
    postmortem bundles (``--flight-recorder``);
  * :mod:`repro_torch.obs.server` — live HTTP telemetry endpoints
    ``/metrics``, ``/healthz``, ``/requests``, ``/snapshot``
    (``--telemetry-port``).
"""
from repro_torch.obs import flight, metrics, numerics, server, trace
from repro_torch.obs.flight import EVENT_TYPES, FlightRecorder
from repro_torch.obs.metrics import (LATENCY_BUCKETS, Counter, Gauge,
                                     Histogram, Registry, log_buckets)
from repro_torch.obs.numerics import (LayerHealth, NumericsPolicy,
                                      check_augmented_r_factors,
                                      check_calibration, check_compression,
                                      check_r_factors, format_report,
                                      triangular_cond, worst_level)
from repro_torch.obs.server import TelemetryServer
from repro_torch.obs.trace import Tracer

__all__ = [
    "trace", "metrics", "numerics", "flight", "server",
    "Counter", "Gauge", "Histogram", "Registry", "LATENCY_BUCKETS",
    "log_buckets",
    "NumericsPolicy", "LayerHealth", "check_augmented_r_factors",
    "check_calibration", "check_compression", "check_r_factors",
    "format_report", "triangular_cond", "worst_level", "Tracer",
    "FlightRecorder", "EVENT_TYPES", "TelemetryServer",
]
