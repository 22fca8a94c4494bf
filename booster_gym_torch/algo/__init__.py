from booster_gym_torch.algo.networks import ActorCritic
from booster_gym_torch.algo.ppo import PPO, TrainState, discount_values

__all__ = ["ActorCritic", "PPO", "TrainState", "discount_values"]
