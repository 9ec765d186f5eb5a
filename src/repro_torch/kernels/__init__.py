"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``<family>/ref.py``) and its wrapper (``<family>/ops.py``)."""
