"""Rendering operators: transforms, SH, projection, tiling, blend, raster."""
