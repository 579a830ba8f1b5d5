"""Slide I/O of the port: the native reader binding, segmentation,
coordinates, the tile stage, stitches, legacy helpers and synthetic
slides."""
