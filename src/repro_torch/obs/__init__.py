"""Flight recorder: copies of ``repro/obs/{events,telemetry}.py``.  The
event registry stays identical to the reference's, which
``scripts/check_events.py`` checks every ``emit`` under ``src/`` against."""
