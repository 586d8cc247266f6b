"""The trainer that owns the device-side training state."""
