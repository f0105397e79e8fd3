"""The configurations' plain references, one module per configuration
(``<config>.py``: ``parameters`` and ``Model``), on the shared pieces of
``plain.py``.  They import nothing of the port."""
