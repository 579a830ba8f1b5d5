"""Hand-written CUDA kernels for Hopper (sm_90a), built with nvcc on first
use (kernels/build.py) and bound with ctypes."""
