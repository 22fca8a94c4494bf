from booster_gym_torch.terrain.heightfield import Terrain

__all__ = ["Terrain"]
