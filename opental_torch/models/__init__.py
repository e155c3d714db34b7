"""Models: layers, I3D backbone, coarse pyramid, BDNet."""
