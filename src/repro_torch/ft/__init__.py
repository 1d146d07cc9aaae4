"""Fault tolerance: the fault plan the serving loop's degradation ladder
runs under (``inject``), the step timer, heartbeats, the in-process
``Pulse`` and the failure injector (``monitor``), and the restart
supervisor (``supervisor``)."""
