"""Feature-bag storage of the port."""
