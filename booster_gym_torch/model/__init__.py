from booster_gym_torch.model.urdf import RobotModel, load_urdf

__all__ = ["RobotModel", "load_urdf"]
