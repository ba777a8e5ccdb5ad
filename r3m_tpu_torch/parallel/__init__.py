"""Data parallelism over several devices: the port of ``r3m_tpu/parallel/``.

`mesh` holds the device mesh of single-process serving, the process group of data-parallel
training (one process a card) and the global batch's row layout; `collectives` the
autograd collectives the data-parallel step is built from.
"""
