from booster_gym_torch.parallel.mesh import (
    Group,
    configured,
    default_backend,
    initialize_distributed,
    largest_world,
    launch,
    process_group,
    rank_device,
)

__all__ = [
    "Group",
    "configured",
    "default_backend",
    "initialize_distributed",
    "largest_world",
    "launch",
    "process_group",
    "rank_device",
]
