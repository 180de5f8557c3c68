"""Rotation conversions for the control interface (copy of
hypervla_tpu/eval/action_space.py; numpy only): self-contained stand-ins for
the transforms3d calls euler2axangle and axangle2euler, static-XYZ ('sxyz')
Euler convention."""
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


def _mat_to_euler(mat: np.ndarray):
    """Inverse of _euler_to_mat (sxyz)."""
    sp = -mat[2, 0]
    sp = np.clip(sp, -1.0, 1.0)
    pitch = np.arcsin(sp)
    if abs(sp) < 1.0 - 1e-10:
        roll = np.arctan2(mat[2, 1], mat[2, 2])
        yaw = np.arctan2(mat[1, 0], mat[0, 0])
    else:  # gimbal lock
        roll = np.arctan2(-mat[1, 2], mat[1, 1])
        yaw = 0.0
    return roll, pitch, yaw


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


def _axangle_to_mat(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = np.cos(angle), np.sin(angle)
    t = 1 - c
    return np.array(
        [
            [t * x * x + c, t * x * y - s * z, t * x * z + s * y],
            [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
            [t * x * z - s * y, t * y * z + s * x, t * z * z + c],
        ]
    )


def euler2axangle(roll: float, pitch: float, yaw: float):
    """(roll, pitch, yaw) sxyz -> (axis, angle)."""
    return _mat_to_axangle(_euler_to_mat(roll, pitch, yaw))


def axangle2euler(axis, angle):
    """(axis, angle) -> (roll, pitch, yaw) sxyz."""
    return _mat_to_euler(_axangle_to_mat(np.asarray(axis, np.float64), angle))


def convert_axangle_to_rpy(axangle: np.ndarray) -> np.ndarray:
    """Scaled axis-angle vector -> (roll, pitch, yaw)."""
    delta = axangle.astype(np.float64)
    angle = np.linalg.norm(delta)
    axis = delta / angle if angle > 1e-6 else np.array([0.0, 1.0, 0.0])
    roll, pitch, yaw = axangle2euler(axis, angle)
    return np.array([roll, pitch, yaw], dtype=axangle.dtype)
