"""Numerical ops of the port: DCT decode, fused ViT block, gated-attention
pooling, YCbCr decode and bag masking."""
