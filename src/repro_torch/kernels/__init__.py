"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions
(``ref.py``) and the operator → kernel dispatch.  Importing these
modules builds nothing: the first launch on a CUDA tensor does."""
