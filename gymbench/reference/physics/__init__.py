from gymbench.reference.physics.types import DynParams, SimConfig, SimState

__all__ = ["SimState", "DynParams", "SimConfig"]
