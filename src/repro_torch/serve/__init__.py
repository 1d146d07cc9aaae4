"""Serving: the single-stream paths (``engine``: ``generate`` and
``monitored_generate``) and the continuous batcher (``sched``)."""
from repro_torch.serve.engine import (generate, make_monitor, monitor_slot,
                                      monitored_generate,
                                      page_mass_from_attention)
from repro_torch.serve.sched import ContinuousBatcher, Request, TrafficMonitor

__all__ = [
    "ContinuousBatcher", "Request", "TrafficMonitor", "generate",
    "make_monitor", "monitor_slot", "monitored_generate",
    "page_mass_from_attention",
]
