"""Step builders and batch shaping."""
