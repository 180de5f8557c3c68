"""Rotation conversion for the control interface (copy of
hypervla_tpu/eval/action_space.py::euler2axangle, static-XYZ 'sxyz'
Euler convention; numpy only)."""
import numpy as np


def _euler_to_mat(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Static-xyz: R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _mat_to_axangle(mat: np.ndarray):
    angle = np.arccos(np.clip((np.trace(mat) - 1) / 2, -1.0, 1.0))
    if angle < 1e-8:
        return np.array([0.0, 1.0, 0.0]), 0.0
    if abs(np.pi - angle) < 1e-6:
        # near-pi: axis from the symmetric part
        diag = (np.diag(mat) + 1.0) / 2.0
        axis = np.sqrt(np.maximum(diag, 0.0))
        if mat[0, 1] + mat[1, 0] < 0:
            axis[1] = -axis[1]
        if mat[0, 2] + mat[2, 0] < 0:
            axis[2] = -axis[2]
        return axis / np.linalg.norm(axis), angle
    axis = np.array(
        [
            mat[2, 1] - mat[1, 2],
            mat[0, 2] - mat[2, 0],
            mat[1, 0] - mat[0, 1],
        ]
    ) / (2 * np.sin(angle))
    return axis, angle


def euler2axangle(roll: float, pitch: float, yaw: float):
    """(roll, pitch, yaw) sxyz -> (axis, angle)."""
    return _mat_to_axangle(_euler_to_mat(roll, pitch, yaw))
