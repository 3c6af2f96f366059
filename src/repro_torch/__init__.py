"""PyTorch/CUDA port of the ``repro`` Qsparse-local-SGD system.

The package mirrors ``repro``'s layout (``core/``, ``kernels/``,
``models/``, ``optim/``, ``data/``, ``train/``) and imports neither
``jax`` nor anything of ``repro``: ``repro`` is the reference the tests
hold it against.  The compression kernels on the training path are
hand-written CUDA C++ for Hopper (``kernels/csrc/``), built with
``nvcc`` at first use.
"""
