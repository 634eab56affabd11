"""Device ops: projection, kernel K1 (geometry) and kernel K2 (raster)."""
