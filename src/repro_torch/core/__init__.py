"""Host-only Cori pieces: the reuse collector and the online tuner
(copies of ``repro/core/{reuse,cori}.py``), plus the initial placement."""
