"""Scene state and its file formats."""
