"""Entry points run as programs: the training driver (``train``)."""
