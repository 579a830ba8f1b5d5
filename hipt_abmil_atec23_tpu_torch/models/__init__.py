"""PyTorch models of the port: DINO ViTs, HIPT_4K, the ResNet and LeViT
patch encoders, the MIL heads and the checkpoint bridges."""
