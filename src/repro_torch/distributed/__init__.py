"""Collectives over ``torch.distributed`` process groups: the int8
compressed all-reduce (``collectives``)."""
