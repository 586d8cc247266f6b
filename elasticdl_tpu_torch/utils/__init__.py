"""Logging, device selection, model specs, export and weight conversion."""
