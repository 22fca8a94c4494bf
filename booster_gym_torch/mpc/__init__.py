from booster_gym_torch.mpc.sampling import SamplingMPC, flat_ground, standup_cost, tile

__all__ = ["SamplingMPC", "flat_ground", "standup_cost", "tile"]
