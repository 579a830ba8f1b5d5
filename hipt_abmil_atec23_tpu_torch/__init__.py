"""hipt_abmil_atec23_tpu_torch — the PyTorch + CUDA (Hopper) port of the
JAX package hipt_abmil_atec23_tpu (its reference).

The JAX package stays the reference; this package mirrors its layout so each
module has a counterpart there, and imports nothing of it. It runs the
tile stage (segmentation, coordinates, stitches, resume journal), the
encode stage (feature bags from slides and coords h5s; HIPT_4K, vit256,
ResNet50-trunc, ResNet-18 and LeViT encoders) and the serving path: slide tiling, the transfer rungs
(sparse-DCT packs, YCbCr planes, RGB) with their decode on the device, the
HIPT_4K region encoder (ViT-256 -> ViT-4K) and a MIL head; the train and
eval stages (every MIL head of the JAX package, k-fold training with early
stopping and .pt checkpoints, online encoding of slide patches in the
training loop, fold evaluation, bootstrap CIs on the device); hyperparameter
tuning, and fold- and trial-parallel training as stacked heads; the JAX
package's flax checkpoints; and exact full-bag MIL inference and training
with the instance axis sharded over processes (torch.distributed).

The DCT unpack, every transformer block and the MIL pooling run through
CUDA kernels written by hand for sm_90a (``kernels/csrc``). The rule is by
tensor device: a CUDA tensor launches the kernel (or raises), a CPU tensor
runs the kernel's plain PyTorch version beside it.

Subpackages:
  models   — ViT-256 / ViT-4K / HIPT4K, ResNet50-trunc / ResNet-18, LeViT,
             CLAM_SB / CLAM_MB / MIL_fc(_mc), checkpoint bridges
  ops      — DCT decode, fused ViT block, gated-attention pooling, YCbCr
             decode, masking, host transforms
  engine   — encoders + slide stream with its rung selector, the encode
             stage, serving, training, evaluation, losses, metrics and
             the bootstrap, checkpoints (torch and flax), the k-fold loop,
             DRAS sampling, tuning, stacked trial lanes
  parallel — process groups, meshes, instance-sharded forward and trainer,
             fold-parallel training
  slideio  — native slide reader binding, segmentation, coordinates, the
             tile stage, stitches, legacy helpers, synthetic and in-memory
             slides
  utils    — the configuration dataclasses, seeding, metrics logging
  data     — feature-bag storage, bag datasets and batches, online-encoded
             bags, manifests, k-fold splits, the task registry, synthetic
             bags
  explain  — attention blockmaps
  kernels  — CUDA sources and their nvcc/ctypes build
  cli      — the tile, encode, train, eval, splits, bootstrap, count,
             serve, heatmap, knn, export and parity commands
"""

__version__ = "0.1.0"
