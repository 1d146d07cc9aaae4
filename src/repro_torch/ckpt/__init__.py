"""Atomic, asynchronous checkpoints of the train state (``checkpoint``)."""
