"""The kernels of the port, one file per kernel, with a torch oracle in
``ref.py`` and the dispatching wrappers in ``ops.py``."""
