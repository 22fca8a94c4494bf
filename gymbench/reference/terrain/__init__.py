from gymbench.reference.terrain.heightfield import Terrain

__all__ = ["Terrain"]
