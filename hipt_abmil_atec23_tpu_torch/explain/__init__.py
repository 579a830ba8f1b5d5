"""Attention artifacts of the port."""
