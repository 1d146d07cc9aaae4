"""Serving: the single-stream paths (``engine``: ``generate`` and
``monitored_generate``), the continuous batcher and its model-free twin
(``sched``), the pipelined loop's background decision worker
(``pipeline``), and the traffic benchmark's full-size replays over that
twin (``traffic_replay``)."""
from repro_torch.serve.engine import (generate, make_monitor, monitor_slot,
                                      monitored_generate,
                                      page_mass_from_attention)
from repro_torch.serve.pipeline import DecisionWorker
from repro_torch.serve.sched import (WORKLOAD_KINDS, ContinuousBatcher,
                                     Request, TrafficMonitor,
                                     TrafficScheduler)

__all__ = [
    "ContinuousBatcher", "DecisionWorker", "Request", "TrafficMonitor",
    "TrafficScheduler", "WORKLOAD_KINDS", "generate",
    "make_monitor", "monitor_slot", "monitored_generate",
    "page_mass_from_attention",
]
