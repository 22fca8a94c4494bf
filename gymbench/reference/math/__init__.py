from gymbench.reference.math.quat import (
    euler_xyz_from_quat,
    quat_conj,
    quat_from_axis_angle,
    quat_from_euler_xyz,
    quat_integrate,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_rotate_inverse,
    quat_to_matrix,
    wrap_to_pi,
)
from gymbench.reference.math.spatial import (
    crf,
    crm,
    rotate_inertia,
    skew,
    spatial_inertia_at_origin,
)

__all__ = [
    "quat_mul", "quat_conj", "quat_rotate", "quat_rotate_inverse",
    "quat_from_euler_xyz", "euler_xyz_from_quat", "quat_to_matrix",
    "quat_from_axis_angle", "quat_integrate", "quat_normalize", "wrap_to_pi",
    "skew", "spatial_inertia_at_origin", "rotate_inertia", "crm", "crf",
]
