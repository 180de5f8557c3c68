"""Open X-Embodiment per-dataset standardization transforms — numpy.

Parity: octo/data/oxe/oxe_standardization_transforms.py (same registry keys,
same action/proprio/language conventions), rewritten for the numpy pipeline.

Input: trajectory dict of batched features (leading time axis).
Output contract per step:
    observation: {<image keys>, <depth keys>, proprio}
    action: chosen action representation
    language_instruction: str
"""
import zlib
from typing import Any, Dict

import numpy as np

from hypervla_tpu_torch.data.data_utils import (
    binarize_gripper_actions,
    invert_gripper_actions,
    rel2abs_gripper_actions,
    relabel_actions,
    tree_map,
)


def _empty_language_like(x) -> np.ndarray:
    return np.array([b""] * len(np.asarray(x).reshape(-1)), dtype=object)


def _zeros_proprio(trajectory) -> np.ndarray:
    return np.zeros((len(trajectory["action"]), 1), dtype=np.float32)


def _euler_from_quaternion(quat: np.ndarray) -> np.ndarray:
    """(x, y, z, w) quaternions -> (roll, pitch, yaw) Euler angles (matches
    tensorflow_graphics euler.from_quaternion)."""
    x, y, z, w = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    sinr_cosp = 2 * (w * x + y * z)
    cosr_cosp = 1 - 2 * (x * x + y * y)
    roll = np.arctan2(sinr_cosp, cosr_cosp)
    sinp = np.clip(2 * (w * y - z * x), -1.0, 1.0)
    pitch = np.arcsin(sinp)
    siny_cosp = 2 * (w * z + x * y)
    cosy_cosp = 1 - 2 * (y * y + z * z)
    yaw = np.arctan2(siny_cosp, cosy_cosp)
    return np.stack([roll, pitch, yaw], axis=-1).astype(np.float32)


def bridge_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        [action[:, :6], binarize_gripper_actions(action[:, -1])[:, None]],
        axis=1,
    )
    trajectory = relabel_actions(trajectory)
    trajectory["observation"]["proprio"] = trajectory["observation"]["state"]
    return trajectory


def rt1_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    gripper = rel2abs_gripper_actions(
        np.asarray(trajectory["action"]["gripper_closedness_action"])[:, 0]
    )
    trajectory["action"] = np.concatenate(
        (
            trajectory["action"]["world_vector"],
            trajectory["action"]["rotation_delta"],
            gripper[:, None],
        ),
        axis=-1,
    ).astype(np.float32)
    trajectory["observation"]["proprio"] = np.concatenate(
        (
            trajectory["observation"]["base_pose_tool_reached"],
            trajectory["observation"]["gripper_closed"],
        ),
        axis=-1,
    ).astype(np.float32)
    trajectory["language_instruction"] = trajectory["observation"][
        "natural_language_instruction"
    ]
    return trajectory


def kuka_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    gripper = rel2abs_gripper_actions(
        np.asarray(trajectory["action"]["gripper_closedness_action"])[:, 0]
    )
    trajectory["action"] = np.concatenate(
        (
            trajectory["action"]["world_vector"],
            trajectory["action"]["rotation_delta"],
            gripper[:, None],
        ),
        axis=-1,
    ).astype(np.float32)

    def _decode_zlib_f32(values, width):
        rows = [
            np.frombuffer(zlib.decompress(bytes(v)), np.float32).reshape(
                -1, width
            )
            for v in np.asarray(values).reshape(-1)
        ]
        return np.concatenate(rows, axis=0)

    eef = _decode_zlib_f32(
        trajectory["observation"]["clip_function_input/base_pose_tool_reached"],
        7,
    )
    grip = _decode_zlib_f32(trajectory["observation"]["gripper_closed"], 1)
    trajectory["observation"]["proprio"] = np.concatenate(
        (eef, grip), axis=-1
    )
    trajectory["language_instruction"] = _empty_language_like(
        trajectory["observation"]["natural_language_instruction"]
    )
    return trajectory


def taco_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"]["rel_actions_world"], np.float32)
    trajectory["action"] = np.concatenate(
        (action[:, :6], np.clip(action[:, -1:], 0, 1)), axis=-1
    )
    robot_obs = trajectory["observation"]["robot_obs"]
    trajectory["observation"]["proprio"] = np.concatenate(
        (robot_obs[:, :6], robot_obs[:, 7:8]), axis=-1
    ).astype(np.float32)
    trajectory["language_instruction"] = trajectory["observation"][
        "natural_language_instruction"
    ]
    return trajectory


def jaco_play_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    gripper = rel2abs_gripper_actions(
        np.asarray(trajectory["action"]["gripper_closedness_action"])[:, 0]
    )
    world = np.asarray(trajectory["action"]["world_vector"], np.float32)
    trajectory["action"] = np.concatenate(
        (world, np.zeros_like(world), gripper[:, None]), axis=-1
    )
    trajectory["observation"]["proprio"] = trajectory["observation"][
        "end_effector_cartesian_pos"
    ]
    trajectory["language_instruction"] = trajectory["observation"][
        "natural_language_instruction"
    ]
    return trajectory


def berkeley_cable_routing_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    world = np.asarray(trajectory["action"]["world_vector"], np.float32)
    trajectory["action"] = np.concatenate(
        (
            world,
            trajectory["action"]["rotation_delta"],
            np.zeros_like(world[:, :1]),
        ),
        axis=-1,
    ).astype(np.float32)
    trajectory["observation"]["proprio"] = trajectory["observation"][
        "robot_state"
    ]
    trajectory["language_instruction"] = _empty_language_like(
        trajectory["observation"]["natural_language_instruction"]
    )
    return trajectory


def roboturk_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    gripper = invert_gripper_actions(
        np.clip(
            np.asarray(
                trajectory["action"]["gripper_closedness_action"], np.float32
            ),
            0,
            1,
        )
    )
    trajectory["action"] = np.concatenate(
        (
            trajectory["action"]["world_vector"],
            trajectory["action"]["rotation_delta"],
            gripper,
        ),
        axis=-1,
    ).astype(np.float32)
    trajectory["observation"]["proprio"] = _zeros_proprio(trajectory)
    trajectory["language_instruction"] = _empty_language_like(
        trajectory["observation"]["natural_language_instruction"]
    )
    return trajectory


def nyu_door_opening_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    gripper = rel2abs_gripper_actions(
        np.asarray(trajectory["action"]["gripper_closedness_action"])[:, 0]
    )
    trajectory["action"] = np.concatenate(
        (
            trajectory["action"]["world_vector"],
            trajectory["action"]["rotation_delta"],
            gripper[:, None],
        ),
        axis=-1,
    ).astype(np.float32)
    trajectory["observation"]["proprio"] = _zeros_proprio(trajectory)
    trajectory["language_instruction"] = _empty_language_like(
        trajectory["observation"]["natural_language_instruction"]
    )
    return trajectory


def viola_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    gripper = invert_gripper_actions(
        np.clip(
            np.asarray(
                trajectory["action"]["gripper_closedness_action"], np.float32
            )[:, None],
            0,
            1,
        )
    )
    trajectory["action"] = np.concatenate(
        (
            trajectory["action"]["world_vector"],
            trajectory["action"]["rotation_delta"],
            gripper,
        ),
        axis=-1,
    ).astype(np.float32)
    trajectory["observation"]["proprio"] = np.concatenate(
        (
            trajectory["observation"]["joint_states"],
            trajectory["observation"]["gripper_states"],
        ),
        axis=-1,
    ).astype(np.float32)
    trajectory["language_instruction"] = _empty_language_like(
        trajectory["observation"]["natural_language_instruction"]
    )
    return trajectory


def berkeley_autolab_ur5_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    trajectory["observation"]["depth"] = trajectory["observation"].pop(
        "image_with_depth"
    )
    gripper = rel2abs_gripper_actions(
        np.asarray(trajectory["action"]["gripper_closedness_action"])
    )
    trajectory["action"] = np.concatenate(
        (
            trajectory["action"]["world_vector"],
            trajectory["action"]["rotation_delta"],
            gripper[:, None],
        ),
        axis=-1,
    ).astype(np.float32)
    trajectory["observation"]["proprio"] = np.asarray(
        trajectory["observation"]["robot_state"], np.float32
    )[:, 6:14]
    trajectory["language_instruction"] = trajectory["observation"][
        "natural_language_instruction"
    ]
    return trajectory


def toto_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    trajectory["action"] = np.concatenate(
        (
            trajectory["action"]["world_vector"],
            trajectory["action"]["rotation_delta"],
            np.asarray(trajectory["action"]["open_gripper"], np.float32)[
                :, None
            ],
        ),
        axis=-1,
    ).astype(np.float32)
    trajectory["observation"]["proprio"] = trajectory["observation"]["state"]
    trajectory["language_instruction"] = _empty_language_like(
        trajectory["observation"]["natural_language_instruction"]
    )
    return trajectory


def language_table_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (
            action,
            np.zeros_like(action),
            np.zeros_like(action),
            np.ones_like(action[:, :1]),
        ),
        axis=-1,
    )
    trajectory["observation"]["proprio"] = trajectory["observation"][
        "effector_translation"
    ]
    # instruction is stored as padded unicode codepoints
    instr = np.asarray(trajectory["observation"]["instruction"])
    decoded = []
    for row in instr:
        chars = [chr(c) for c in row if c != 0]
        decoded.append("".join(chars).encode("utf-8"))
    trajectory["language_instruction"] = np.array(decoded, dtype=object)
    return trajectory


def pusht_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    trajectory["action"] = np.concatenate(
        (
            trajectory["action"]["world_vector"],
            trajectory["action"]["rotation_delta"],
            np.asarray(
                trajectory["action"]["gripper_closedness_action"], np.float32
            )[:, None],
        ),
        axis=-1,
    ).astype(np.float32)
    trajectory["observation"]["proprio"] = trajectory["observation"][
        "robot_state"
    ]
    trajectory["language_instruction"] = trajectory["observation"][
        "natural_language_instruction"
    ]
    return trajectory


def stanford_kuka_multimodal_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    trajectory["observation"]["depth_image"] = np.asarray(
        trajectory["observation"]["depth_image"]
    )[..., 0]
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (action[:, :3], np.zeros_like(action[:, :3]), action[:, -1:]), axis=-1
    )
    trajectory["observation"]["proprio"] = np.concatenate(
        (
            trajectory["observation"]["ee_position"],
            trajectory["observation"]["ee_orientation"],
        ),
        axis=-1,
    ).astype(np.float32)
    return trajectory


def nyu_rot_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    trajectory["action"] = np.asarray(trajectory["action"], np.float32)[..., :7]
    trajectory["observation"]["proprio"] = trajectory["observation"]["state"]
    return trajectory


def stanford_hydra_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (action[:, :6], invert_gripper_actions(action[:, -1:])), axis=-1
    )
    state = np.asarray(trajectory["observation"]["state"], np.float32)
    trajectory["observation"]["proprio"] = np.concatenate(
        (state[:, :3], state[:, 7:10], state[:, -3:-2]), axis=-1
    )
    trajectory["language_instruction"] = _empty_language_like(
        trajectory["language_instruction"]
    )
    return trajectory


def austin_buds_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (
            action[:, :6],
            invert_gripper_actions(np.clip(action[:, -1:], 0, 1)),
        ),
        axis=-1,
    )
    trajectory["observation"]["proprio"] = np.asarray(
        trajectory["observation"]["state"], np.float32
    )[:, :8]
    trajectory["language_instruction"] = _empty_language_like(
        trajectory["language_instruction"]
    )
    return trajectory


def nyu_franka_play_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    trajectory["observation"]["depth"] = np.asarray(
        trajectory["observation"]["depth"], np.float32
    )[..., 0]
    trajectory["observation"]["depth_additional_view"] = np.asarray(
        trajectory["observation"]["depth_additional_view"], np.float32
    )[..., 0]
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (action[:, -8:-2], np.clip(action[:, -2:-1], 0, 1)), axis=-1
    )
    trajectory["observation"]["proprio"] = np.asarray(
        trajectory["observation"]["state"], np.float32
    )[:, -6:]
    trajectory["language_instruction"] = _empty_language_like(
        trajectory["language_instruction"]
    )
    return trajectory


def maniskill_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    trajectory["observation"]["proprio"] = np.concatenate(
        (
            trajectory["observation"]["tcp_pose"],
            np.asarray(trajectory["observation"]["state"], np.float32)[:, 7:8],
        ),
        axis=-1,
    ).astype(np.float32)
    return trajectory


def furniture_bench_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (
            action[:, :3],
            _euler_from_quaternion(action[:, 3:7]),
            invert_gripper_actions(np.clip(action[:, -1:], 0, 1)),
        ),
        axis=-1,
    )
    state = np.asarray(trajectory["observation"]["state"], np.float32)
    trajectory["observation"]["proprio"] = np.concatenate(
        (state[:, :7], state[:, -1:]), axis=-1
    )
    return trajectory


def cmu_franka_exploration_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    trajectory["action"] = np.asarray(trajectory["action"], np.float32)[..., :-1]
    trajectory["observation"]["proprio"] = _zeros_proprio(trajectory)
    return trajectory


def ucsd_kitchen_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    trajectory["action"] = np.asarray(trajectory["action"], np.float32)[..., :-1]
    trajectory["observation"]["proprio"] = np.asarray(
        trajectory["observation"]["state"], np.float32
    )[:, :7]
    return trajectory


def ucsd_pick_place_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (action[:, :3], np.zeros_like(action[:, :3]), action[:, -1:]), axis=-1
    )
    trajectory["observation"]["proprio"] = trajectory["observation"]["state"]
    return trajectory


def austin_sailor_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (
            action[:, :6],
            invert_gripper_actions(np.clip(action[:, -1:], 0, 1)),
        ),
        axis=-1,
    )
    trajectory["observation"]["proprio"] = trajectory["observation"]["state"]
    trajectory["language_instruction"] = _empty_language_like(
        trajectory["language_instruction"]
    )
    return trajectory


def austin_sirius_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (
            action[:, :6],
            invert_gripper_actions(np.clip(action[:, -1:], 0, 1)),
        ),
        axis=-1,
    )
    trajectory["observation"]["proprio"] = trajectory["observation"]["state"]
    trajectory["language_instruction"] = _empty_language_like(
        trajectory["language_instruction"]
    )
    return trajectory


def bc_z_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    trajectory["action"] = np.concatenate(
        (
            np.asarray(trajectory["action"]["future/xyz_residual"], np.float32)[
                :, :3
            ],
            np.asarray(
                trajectory["action"]["future/axis_angle_residual"], np.float32
            )[:, :3],
            invert_gripper_actions(
                np.asarray(
                    trajectory["action"]["future/target_close"], np.float32
                )[:, :1]
            ),
        ),
        axis=-1,
    )
    trajectory["observation"]["proprio"] = np.concatenate(
        (
            trajectory["observation"]["present/xyz"],
            trajectory["observation"]["present/axis_angle"],
            trajectory["observation"]["present/sensed_close"],
        ),
        axis=-1,
    ).astype(np.float32)
    trajectory["language_instruction"] = trajectory["observation"][
        "natural_language_instruction"
    ]
    return trajectory


def tokyo_pr2_opening_fridge_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    trajectory["action"] = np.asarray(trajectory["action"], np.float32)[..., :-1]
    trajectory["observation"]["proprio"] = trajectory["observation"]["state"]
    return trajectory


def tokyo_pr2_tabletop_manipulation_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    trajectory["action"] = np.asarray(trajectory["action"], np.float32)[..., :-1]
    trajectory["observation"]["proprio"] = trajectory["observation"]["state"]
    return trajectory


def utokyo_xarm_pick_place_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    return trajectory


def utokyo_xarm_bimanual_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    trajectory["action"] = np.asarray(trajectory["action"], np.float32)[..., -7:]
    trajectory["observation"]["proprio"] = trajectory["observation"][
        "end_effector_pose"
    ]
    return trajectory


def robo_net_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (action[:, :4], np.zeros_like(action[:, :2]), action[:, -1:]), axis=-1
    )
    state = np.asarray(trajectory["observation"]["state"], np.float32)
    trajectory["observation"]["proprio"] = np.concatenate(
        (state[:, :4], np.zeros_like(state[:, :2]), state[:, -1:]), axis=-1
    )
    return trajectory


def berkeley_mvp_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    trajectory["observation"]["proprio"] = np.concatenate(
        (
            trajectory["observation"]["pose"],
            np.asarray(trajectory["observation"]["gripper"], np.float32)[
                :, None
            ],
        ),
        axis=-1,
    ).astype(np.float32)
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        [action[:, :-1], invert_gripper_actions(action[:, -1:])], axis=1
    )
    return trajectory


def berkeley_rpt_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    factor = 3  # 30Hz -> 10Hz
    trajectory = tree_map(lambda x: x[::factor], trajectory)
    trajectory["observation"]["proprio"] = np.concatenate(
        (
            trajectory["observation"]["joint_pos"],
            np.asarray(trajectory["observation"]["gripper"], np.float32)[
                :, None
            ],
        ),
        axis=-1,
    ).astype(np.float32)
    joint_actions = (
        trajectory["observation"]["joint_pos"][1:, :7]
        - trajectory["observation"]["joint_pos"][:-1, :7]
    )
    traj_truncated = tree_map(lambda x: x[:-1], trajectory)
    traj_truncated["action"] = np.concatenate(
        [
            joint_actions,
            invert_gripper_actions(
                np.asarray(trajectory["action"], np.float32)[:-1, -1:]
            ),
        ],
        axis=1,
    )
    return traj_truncated


def kaist_nonprehensible_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (action[:, :6], np.zeros_like(action[:, :1])), axis=-1
    )
    trajectory["observation"]["proprio"] = np.asarray(
        trajectory["observation"]["state"], np.float32
    )[:, -7:]
    return trajectory


def stanford_mask_vit_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (action[:, :4], np.zeros_like(action[:, :2]), action[:, -1:]), axis=-1
    )
    eep = np.asarray(trajectory["observation"]["end_effector_pose"], np.float32)
    trajectory["observation"]["proprio"] = np.concatenate(
        (eep[:, :4], np.zeros_like(eep[:, :2]), eep[:, -1:]), axis=-1
    )
    return trajectory


def tokyo_lsmo_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    state = np.asarray(trajectory["observation"]["state"], np.float32)
    trajectory["observation"]["proprio"] = np.concatenate(
        (state[:, :6], state[:, -1:]), axis=-1
    )
    return trajectory


def dlr_sara_pour_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    trajectory["observation"]["proprio"] = trajectory["observation"]["state"]
    return trajectory


def dlr_sara_grid_clamp_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    trajectory["observation"]["proprio"] = np.asarray(
        trajectory["observation"]["state"], np.float32
    )[:, :6]
    return trajectory


def dlr_edan_shared_control_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (action[:, :6], invert_gripper_actions(action[:, -1:])), axis=-1
    )
    trajectory["observation"]["proprio"] = trajectory["observation"]["state"]
    return trajectory


def asu_table_top_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    trajectory["observation"]["proprio"] = np.concatenate(
        (
            trajectory["ground_truth_states"]["EE"],
            np.asarray(trajectory["observation"]["state"], np.float32)[:, -1:],
        ),
        axis=-1,
    ).astype(np.float32)
    return trajectory


def robocook_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    trajectory["observation"]["proprio"] = trajectory["observation"]["state"]
    return trajectory


def imperial_wristcam_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    trajectory["action"] = np.asarray(trajectory["action"], np.float32)[..., :-1]
    trajectory["observation"]["proprio"] = _zeros_proprio(trajectory)
    return trajectory


def iamlab_pick_insert_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (
            action[:, :3],
            _euler_from_quaternion(action[:, 3:7]),
            action[:, 7:8],
        ),
        axis=-1,
    )
    state = np.asarray(trajectory["observation"]["state"], np.float32)
    trajectory["observation"]["proprio"] = np.concatenate(
        (state[:, :7], state[:, 7:8]), axis=-1
    )
    return trajectory


def uiuc_d3field_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (action, np.zeros_like(action), np.zeros_like(action[:, :1])), axis=-1
    )
    trajectory["observation"]["proprio"] = _zeros_proprio(trajectory)
    return trajectory


def utaustin_mutex_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (
            action[:, :6],
            invert_gripper_actions(np.clip(action[:, -1:], 0, 1)),
        ),
        axis=-1,
    )
    trajectory["observation"]["proprio"] = np.asarray(
        trajectory["observation"]["state"], np.float32
    )[:, :8]
    trajectory["language_instruction"] = _empty_language_like(
        trajectory["language_instruction"]
    )
    return trajectory


def berkeley_fanuc_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    state = np.asarray(trajectory["observation"]["state"], np.float32)
    trajectory["action"] = np.concatenate(
        (
            np.asarray(trajectory["action"], np.float32),
            invert_gripper_actions(state[:, 6:7]),
        ),
        axis=-1,
    )
    trajectory["observation"]["proprio"] = np.concatenate(
        (state[:, :6], state[:, 6:7]), axis=-1
    )
    return trajectory


def cmu_playing_with_food_dataset_transform(
    trajectory: Dict[str, Any],
) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (
            action[:, :3],
            _euler_from_quaternion(action[:, 3:7]),
            action[:, -1:],
        ),
        axis=-1,
    )
    trajectory["observation"]["proprio"] = trajectory["observation"]["state"]
    return trajectory


def playfusion_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (action[:, :3], action[:, -4:]), axis=-1
    )
    trajectory["observation"]["proprio"] = trajectory["observation"]["state"]
    return trajectory


def cmu_stretch_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    trajectory["action"] = np.asarray(trajectory["action"], np.float32)[..., :-1]
    state = np.asarray(trajectory["observation"]["state"], np.float32)
    trajectory["observation"]["proprio"] = np.concatenate(
        (state[:, :3], np.zeros_like(state[:, :3]), state[:, -1:]), axis=-1
    )
    return trajectory


def gnm_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    if len(trajectory["action"]) <= 1:
        return tree_map(lambda x: x[:0], trajectory)
    scaling_factor = np.linalg.norm(trajectory["action"][0]) / max(
        np.linalg.norm(
            trajectory["observation"]["position"][1]
            - trajectory["observation"]["position"][0]
        ),
        1e-12,
    )
    traj = tree_map(lambda x: x[::3], trajectory)
    yaw = np.asarray(traj["observation"]["yaw"], np.float32)[..., 0]
    pos = np.asarray(traj["observation"]["position"], np.float32)
    rot_mat = np.stack(
        [
            np.stack([np.cos(yaw), -np.sin(yaw)], axis=-1),
            np.stack([np.sin(yaw), np.cos(yaw)], axis=-1),
        ],
        axis=-2,
    )
    delta = pos[1:] - pos[:-1]
    action = np.einsum("nj,njk->nk", delta, rot_mat[:-1]) * scaling_factor
    traj = tree_map(lambda x: x[:-1], traj)
    traj["action"] = action.astype(np.float32)
    traj["observation"]["proprio"] = traj["observation"]["state"]
    return traj


def aloha_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    factor = 5  # 50Hz -> 10Hz
    trajectory = tree_map(lambda x: x[::factor], trajectory)
    trajectory["observation"]["proprio"] = trajectory["observation"]["state"]
    return trajectory


def fmb_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    trajectory["observation"]["proprio"] = np.concatenate(
        (
            trajectory["observation"]["eef_pose"],
            np.asarray(
                trajectory["observation"]["state_gripper_pose"], np.float32
            )[..., None],
        ),
        axis=-1,
    ).astype(np.float32)
    return trajectory


def dobbe_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    trajectory["observation"]["proprio"] = trajectory["observation"]["state"]
    return trajectory


def roboset_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    trajectory["observation"]["proprio"] = trajectory["observation"]["state"]
    action = np.asarray(trajectory["action"], np.float32)
    gripper = invert_gripper_actions(np.clip(action[:, -1:], 0, 1))
    trajectory["action"] = np.concatenate((action[:, :7], gripper), axis=-1)
    return trajectory


def rh20t_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    trajectory["action"] = np.concatenate(
        (
            trajectory["action"]["tcp_base"],
            np.asarray(trajectory["action"]["gripper"], np.float32)[:, None],
        ),
        axis=-1,
    ).astype(np.float32)
    trajectory["observation"]["proprio"] = np.concatenate(
        (
            trajectory["observation"]["tcp_base"],
            np.asarray(
                trajectory["observation"]["gripper_width"], np.float32
            )[..., None],
        ),
        axis=-1,
    ).astype(np.float32)
    return trajectory


def mujoco_manip_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    action = np.asarray(trajectory["action"], np.float32)
    gripper = invert_gripper_actions(action[:, -1:] / 255)
    trajectory["action"] = np.concatenate((action[:, :6], gripper), axis=-1)
    return trajectory


def metaworld_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    # metaworld uses 0 for open / 1 for close; flip so +1 = open
    action = np.asarray(trajectory["action"], np.float32)
    trajectory["action"] = np.concatenate(
        (action[:, :3], 1.0 - np.round(action[:, 3:])), axis=-1
    )
    return trajectory


def libero_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    return trajectory


OXE_STANDARDIZATION_TRANSFORMS = {
    "bridge_dataset": bridge_dataset_transform,
    "fractal20220817_data": rt1_dataset_transform,
    "kuka": kuka_dataset_transform,
    "taco_play": taco_dataset_transform,
    "jaco_play": jaco_play_dataset_transform,
    "berkeley_cable_routing": berkeley_cable_routing_dataset_transform,
    "roboturk": roboturk_dataset_transform,
    "nyu_door_opening_surprising_effectiveness": nyu_door_opening_dataset_transform,
    "viola": viola_dataset_transform,
    "berkeley_autolab_ur5": berkeley_autolab_ur5_dataset_transform,
    "toto": toto_dataset_transform,
    "language_table": language_table_dataset_transform,
    "columbia_cairlab_pusht_real": pusht_dataset_transform,
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds": stanford_kuka_multimodal_dataset_transform,
    "nyu_rot_dataset_converted_externally_to_rlds": nyu_rot_dataset_transform,
    "stanford_hydra_dataset_converted_externally_to_rlds": stanford_hydra_dataset_transform,
    "austin_buds_dataset_converted_externally_to_rlds": austin_buds_dataset_transform,
    "nyu_franka_play_dataset_converted_externally_to_rlds": nyu_franka_play_dataset_transform,
    "maniskill_dataset_converted_externally_to_rlds": maniskill_dataset_transform,
    "furniture_bench_dataset_converted_externally_to_rlds": furniture_bench_dataset_transform,
    "cmu_franka_exploration_dataset_converted_externally_to_rlds": cmu_franka_exploration_dataset_transform,
    "ucsd_kitchen_dataset_converted_externally_to_rlds": ucsd_kitchen_dataset_transform,
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds": ucsd_pick_place_dataset_transform,
    "austin_sailor_dataset_converted_externally_to_rlds": austin_sailor_dataset_transform,
    "austin_sirius_dataset_converted_externally_to_rlds": austin_sirius_dataset_transform,
    "bc_z": bc_z_dataset_transform,
    "utokyo_pr2_opening_fridge_converted_externally_to_rlds": tokyo_pr2_opening_fridge_dataset_transform,
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds": tokyo_pr2_tabletop_manipulation_dataset_transform,
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds": utokyo_xarm_pick_place_dataset_transform,
    "utokyo_xarm_bimanual_converted_externally_to_rlds": utokyo_xarm_bimanual_dataset_transform,
    "robo_net": robo_net_dataset_transform,
    "berkeley_mvp_converted_externally_to_rlds": berkeley_mvp_dataset_transform,
    "berkeley_rpt_converted_externally_to_rlds": berkeley_rpt_dataset_transform,
    "kaist_nonprehensile_converted_externally_to_rlds": kaist_nonprehensible_dataset_transform,
    "stanford_mask_vit_converted_externally_to_rlds": stanford_mask_vit_dataset_transform,
    "tokyo_u_lsmo_converted_externally_to_rlds": tokyo_lsmo_dataset_transform,
    "dlr_sara_pour_converted_externally_to_rlds": dlr_sara_pour_dataset_transform,
    "dlr_sara_grid_clamp_converted_externally_to_rlds": dlr_sara_grid_clamp_dataset_transform,
    "dlr_edan_shared_control_converted_externally_to_rlds": dlr_edan_shared_control_dataset_transform,
    "asu_table_top_converted_externally_to_rlds": asu_table_top_dataset_transform,
    "stanford_robocook_converted_externally_to_rlds": robocook_dataset_transform,
    "imperialcollege_sawyer_wrist_cam": imperial_wristcam_dataset_transform,
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds": iamlab_pick_insert_dataset_transform,
    "uiuc_d3field": uiuc_d3field_dataset_transform,
    "utaustin_mutex": utaustin_mutex_dataset_transform,
    "berkeley_fanuc_manipulation": berkeley_fanuc_dataset_transform,
    "cmu_playing_with_food": cmu_playing_with_food_dataset_transform,
    "cmu_play_fusion": playfusion_dataset_transform,
    "cmu_stretch": cmu_stretch_dataset_transform,
    "gnm_dataset": gnm_dataset_transform,
    "aloha_static_dataset": aloha_dataset_transform,
    "aloha_dagger_dataset": aloha_dataset_transform,
    "aloha_mobile_dataset": aloha_dataset_transform,
    "fmb_dataset": fmb_dataset_transform,
    "dobbe": dobbe_dataset_transform,
    "roboset": roboset_dataset_transform,
    "rh20t": rh20t_dataset_transform,
    "mujoco_manip": mujoco_manip_dataset_transform,
    "metaworld_dataset": metaworld_dataset_transform,
    "libero_dataset": libero_dataset_transform,
}
