"""Synthetic EDLIO datasets."""
