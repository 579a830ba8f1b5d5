"""Encoder, slide stream and serving on the port."""
