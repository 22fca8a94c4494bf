from booster_gym_torch.mpc.sampling import SamplingMPC, standup_cost, tile

__all__ = ["SamplingMPC", "standup_cost", "tile"]
