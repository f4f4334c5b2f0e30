"""Hand-written CUDA kernels of the port (built with nvcc for sm_90a at
first use), each beside its plain PyTorch version in `ref.py`."""
