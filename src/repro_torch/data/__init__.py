"""The deterministic synthetic data stream the trainer reads
(``pipeline``)."""
