"""Data parallel over cards (``munit_tpu/dist`` of the JAX package): one
process a card in a ``torch.distributed`` group, and ``Replicas`` for the
one-process ``--mesh auto`` of the inference commands (``mesh.py``)."""
