"""Flight recorder: copies of ``repro/obs/{events,telemetry,export,
report}.py``.  The event registry stays identical to the reference's,
which ``scripts/check_events.py`` checks every ``emit`` under ``src/``
against; ``python -m repro_torch.obs.report LOG.jsonl`` replays a log.

Read ``RECORDER`` through the module attribute (``obs.RECORDER`` or
``telemetry.RECORDER``): ``install()`` rebinds it."""
from repro_torch.obs import telemetry as telemetry
from repro_torch.obs.events import EVENTS, Event, RESERVED_FIELDS
from repro_torch.obs.export import (SCHEMA, perfetto_trace, read_jsonl,
                                    write_jsonl, write_perfetto)
from repro_torch.obs.telemetry import Histogram, Recorder, get, install

__all__ = [
    "EVENTS", "Event", "RESERVED_FIELDS",
    "Histogram", "Recorder", "RECORDER", "install", "get",
    "SCHEMA", "write_jsonl", "read_jsonl", "perfetto_trace",
    "write_perfetto",
]


def __getattr__(name):
    # RECORDER must stay live across install(): delegate to telemetry's
    # module attribute instead of snapshotting it at import time.
    if name == "RECORDER":
        return telemetry.RECORDER
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
