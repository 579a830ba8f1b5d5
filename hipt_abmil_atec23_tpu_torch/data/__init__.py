"""Feature-bag storage, bag datasets, splits and tasks of the port."""
