"""Dataset converters (``prepare_kitti``)."""
