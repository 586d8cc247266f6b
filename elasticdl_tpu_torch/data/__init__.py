"""The data layer: EDLIO shards, readers, the dataset pipeline."""
