"""Slide I/O of the port: the native reader binding, segmentation,
coordinates, and synthetic slides."""
