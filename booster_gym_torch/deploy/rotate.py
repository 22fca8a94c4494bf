"""RPY-inverse gravity projection (reference: deploy/utils/rotate.py:4-20)."""

import numpy as np


def rotate_vector_inverse_rpy(roll, pitch, yaw, vector):
    """Rotate a world vector into the body frame given body RPY."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_x = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    R_y = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    R_z = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return (R_z @ R_y @ R_x).T @ vector
