"""Numerical ops of the port: DCT decode, fused ViT block and block stack,
gated-attention pooling, YCbCr decode, bag masking and the host transforms
(augment)."""
