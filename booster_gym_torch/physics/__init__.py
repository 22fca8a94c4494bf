from booster_gym_torch.physics.types import DynParams, SimConfig, SimState

__all__ = ["SimState", "DynParams", "SimConfig"]
