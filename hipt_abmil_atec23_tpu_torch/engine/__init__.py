"""Encoder, slide stream, serving, training and evaluation on the port."""
