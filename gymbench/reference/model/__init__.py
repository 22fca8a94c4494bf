from gymbench.reference.model.urdf import RobotModel, load_urdf

__all__ = ["RobotModel", "load_urdf"]
