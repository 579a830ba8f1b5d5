"""hipt_abmil_atec23_tpu_torch — the PyTorch + CUDA (Hopper) port of
hipt_abmil_atec23_tpu.

The JAX package stays the reference; this package mirrors its layout so each
module has a counterpart there. It runs the serving path: slide tiling
(shared with the JAX package's framework-neutral ``slideio``), the HIPT_4K
region encoder (ViT-256 -> ViT-4K) and the CLAM_SB gated-attention MIL head.

Every transformer block and the MIL pooling run through CUDA kernels written
by hand for sm_90a (``kernels/csrc``). The rule is by tensor device: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the kernel's plain
PyTorch version beside it.

Subpackages:
  models   — ViT-256 / ViT-4K / HIPT4K, CLAM_SB, checkpoint bridges
  ops      — fused ViT block, gated-attention pooling, YCbCr decode, masking
  engine   — encoder + slide stream, serving
  kernels  — CUDA sources and their nvcc/ctypes build
"""

__version__ = "0.1.0"
