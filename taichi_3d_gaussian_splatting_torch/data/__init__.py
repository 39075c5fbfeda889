"""Image + pose datasets."""
