"""The plain reference that decides ``correct``: numpy and plain PyTorch,
importing nothing of the port or of the JAX package.  It recomputes a
frame from the chunk positions and the pose: the terrain, the meshes, the
draw list, the expansion, stage A and the raster.  The modules named as
frozen copies are the port's plain code as it stood at commit 1521963."""
