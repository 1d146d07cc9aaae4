"""Serving: single-stream ``generate`` and the continuous batcher."""
