"""Fault-tolerance pieces the serving loop carries: the (inert by default)
fault plan and ``StepTimer``."""
