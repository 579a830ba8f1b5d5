"""Numerical ops of the port: fused ViT block, gated-attention pooling,
YCbCr decode and bag masking."""
