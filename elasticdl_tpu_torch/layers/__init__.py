"""Model-building layers of the port."""
