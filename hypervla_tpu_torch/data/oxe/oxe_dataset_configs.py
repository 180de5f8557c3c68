"""Open X-Embodiment dataset configurations.

Parity: octo/data/oxe/oxe_dataset_configs.py — per-dataset camera-view key
mappings plus proprio/action encodings. Expressed via a compact constructor
instead of repeated literal dicts.
"""
from enum import IntEnum


class ProprioEncoding(IntEnum):
    NONE = -1        # no proprio provided
    POS_EULER = 1    # EEF XYZ + roll-pitch-yaw + gripper open/close
    POS_QUAT = 2     # EEF XYZ + quaternion + gripper open/close
    JOINT = 3        # joint angles + gripper open/close
    JOINT_BIMANUAL = 4  # 2 x [6 joint angles + gripper]
    POS_NAV = 5      # XY + yaw


class ActionEncoding(IntEnum):
    EEF_POS = 1              # EEF delta XYZ + rpy + gripper
    JOINT_POS = 2            # 7 joint deltas + gripper
    JOINT_POS_BIMANUAL = 3   # 2 x [6 joint pos + gripper]
    NAV_2D = 4               # [dx, dy] waypoint
    JOINT_POS_BIMANUAL_NAV = 5  # bimanual + base linear/angular vel


def _cfg(primary=None, secondary=None, wrist=None,
         depth_primary=None, depth_secondary=None, depth_wrist=None,
         proprio=ProprioEncoding.NONE, action=ActionEncoding.EEF_POS):
    return {
        "image_obs_keys": {
            "primary": primary, "secondary": secondary, "wrist": wrist
        },
        "depth_obs_keys": {
            "primary": depth_primary, "secondary": depth_secondary,
            "wrist": depth_wrist,
        },
        "proprio_encoding": proprio,
        "action_encoding": action,
    }


PE, AE = ProprioEncoding, ActionEncoding

OXE_DATASET_CONFIGS = {
    "fractal20220817_data": _cfg(primary="image", proprio=PE.POS_QUAT),
    "kuka": _cfg(primary="image", proprio=PE.POS_QUAT),
    # note: the "bridge_dataset" copy is RAIL's updated release, not the OXE one
    "bridge_dataset": _cfg(primary="image_0", secondary="image_1",
                           proprio=PE.POS_EULER),
    "taco_play": _cfg(primary="rgb_static", wrist="rgb_gripper",
                      depth_primary="depth_static",
                      depth_wrist="depth_gripper", proprio=PE.POS_EULER),
    "jaco_play": _cfg(primary="image", wrist="image_wrist",
                      proprio=PE.POS_EULER),
    "berkeley_cable_routing": _cfg(primary="image", secondary="top_image",
                                   wrist="wrist45_image", proprio=PE.JOINT),
    "roboturk": _cfg(primary="front_rgb"),
    "nyu_door_opening_surprising_effectiveness": _cfg(wrist="image"),
    "viola": _cfg(primary="agentview_rgb", wrist="eye_in_hand_rgb",
                  proprio=PE.JOINT),
    "berkeley_autolab_ur5": _cfg(primary="image", wrist="hand_image",
                                 depth_primary="depth", proprio=PE.POS_QUAT),
    "toto": _cfg(primary="image", proprio=PE.JOINT),
    "language_table": _cfg(primary="rgb", proprio=PE.POS_EULER),
    "columbia_cairlab_pusht_real": _cfg(primary="image", wrist="wrist_image",
                                        proprio=PE.POS_EULER),
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds": _cfg(
        primary="image", depth_primary="depth_image", proprio=PE.POS_QUAT
    ),
    "nyu_rot_dataset_converted_externally_to_rlds": _cfg(
        primary="image", proprio=PE.POS_EULER
    ),
    "stanford_hydra_dataset_converted_externally_to_rlds": _cfg(
        primary="image", wrist="wrist_image", proprio=PE.POS_EULER
    ),
    "austin_buds_dataset_converted_externally_to_rlds": _cfg(
        primary="image", wrist="wrist_image", proprio=PE.JOINT
    ),
    "nyu_franka_play_dataset_converted_externally_to_rlds": _cfg(
        primary="image", secondary="image_additional_view",
        depth_primary="depth", depth_secondary="depth_additional_view",
        proprio=PE.POS_EULER,
    ),
    "maniskill_dataset_converted_externally_to_rlds": _cfg(
        primary="image", wrist="wrist_image", depth_primary="depth",
        depth_wrist="wrist_depth", proprio=PE.POS_QUAT,
    ),
    "furniture_bench_dataset_converted_externally_to_rlds": _cfg(
        primary="image", wrist="wrist_image", proprio=PE.POS_QUAT
    ),
    "cmu_franka_exploration_dataset_converted_externally_to_rlds": _cfg(
        primary="highres_image"
    ),
    "ucsd_kitchen_dataset_converted_externally_to_rlds": _cfg(
        primary="image", proprio=PE.JOINT
    ),
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds": _cfg(
        primary="image", proprio=PE.POS_EULER
    ),
    "austin_sailor_dataset_converted_externally_to_rlds": _cfg(
        primary="image", wrist="wrist_image", proprio=PE.POS_QUAT
    ),
    "austin_sirius_dataset_converted_externally_to_rlds": _cfg(
        primary="image", wrist="wrist_image", proprio=PE.POS_QUAT
    ),
    "bc_z": _cfg(primary="image", proprio=PE.POS_EULER),
    "utokyo_pr2_opening_fridge_converted_externally_to_rlds": _cfg(
        primary="image", proprio=PE.POS_EULER
    ),
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds": _cfg(
        primary="image", proprio=PE.POS_EULER
    ),
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds": _cfg(
        primary="image", secondary="image2", wrist="hand_image",
        proprio=PE.POS_EULER,
    ),
    "utokyo_xarm_bimanual_converted_externally_to_rlds": _cfg(
        primary="image", proprio=PE.POS_EULER
    ),
    "robo_net": _cfg(primary="image", secondary="image1",
                     proprio=PE.POS_EULER),
    "berkeley_mvp_converted_externally_to_rlds": _cfg(
        wrist="hand_image", proprio=PE.POS_QUAT, action=AE.JOINT_POS
    ),
    "berkeley_rpt_converted_externally_to_rlds": _cfg(
        wrist="hand_image", proprio=PE.JOINT, action=AE.JOINT_POS
    ),
    "kaist_nonprehensile_converted_externally_to_rlds": _cfg(
        primary="image", proprio=PE.POS_QUAT
    ),
    "stanford_mask_vit_converted_externally_to_rlds": _cfg(
        primary="image", proprio=PE.POS_EULER
    ),
    "tokyo_u_lsmo_converted_externally_to_rlds": _cfg(
        primary="image", proprio=PE.POS_EULER
    ),
    "dlr_sara_pour_converted_externally_to_rlds": _cfg(
        primary="image", proprio=PE.POS_EULER
    ),
    "dlr_sara_grid_clamp_converted_externally_to_rlds": _cfg(
        primary="image", proprio=PE.POS_EULER
    ),
    "dlr_edan_shared_control_converted_externally_to_rlds": _cfg(
        primary="image", proprio=PE.POS_EULER
    ),
    "asu_table_top_converted_externally_to_rlds": _cfg(
        primary="image", proprio=PE.POS_EULER
    ),
    "stanford_robocook_converted_externally_to_rlds": _cfg(
        primary="image_1", secondary="image_2", depth_primary="depth_1",
        depth_secondary="depth_2", proprio=PE.POS_EULER,
    ),
    "imperialcollege_sawyer_wrist_cam": _cfg(
        primary="image", wrist="wrist_image"
    ),
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds": _cfg(
        primary="image", wrist="wrist_image", proprio=PE.JOINT
    ),
    "uiuc_d3field": _cfg(primary="image_1", secondary="image_2",
                         depth_primary="depth_1", depth_secondary="depth_2"),
    "utaustin_mutex": _cfg(primary="image", wrist="wrist_image",
                           proprio=PE.JOINT),
    "berkeley_fanuc_manipulation": _cfg(primary="image", wrist="wrist_image",
                                        proprio=PE.JOINT),
    "cmu_playing_with_food": _cfg(primary="image", wrist="finger_vision_1",
                                  proprio=PE.POS_EULER),
    "cmu_play_fusion": _cfg(primary="image", proprio=PE.JOINT),
    "cmu_stretch": _cfg(primary="image", proprio=PE.POS_EULER),
    "gnm_dataset": _cfg(primary="image", proprio=PE.POS_NAV, action=AE.NAV_2D),
    "aloha_static_dataset": _cfg(
        primary="cam_high", secondary="cam_low", wrist="cam_right_wrist",
        proprio=PE.JOINT_BIMANUAL, action=AE.JOINT_POS_BIMANUAL,
    ),
    "aloha_dagger_dataset": _cfg(
        primary="cam_high", secondary="cam_low", wrist="cam_right_wrist",
        proprio=PE.JOINT_BIMANUAL, action=AE.JOINT_POS_BIMANUAL,
    ),
    "aloha_mobile_dataset": _cfg(
        primary="cam_high", wrist="cam_right_wrist",
        proprio=PE.JOINT_BIMANUAL, action=AE.JOINT_POS_BIMANUAL_NAV,
    ),
    "fmb_dataset": _cfg(
        primary="image_side_1", secondary="image_side_2",
        wrist="image_wrist_1", depth_primary="image_side_1_depth",
        depth_secondary="image_side_2_depth",
        depth_wrist="image_wrist_1_depth", proprio=PE.POS_EULER,
    ),
    "dobbe": _cfg(wrist="wrist_image", proprio=PE.POS_EULER),
    "roboset": _cfg(primary="image_left", secondary="image_right",
                    wrist="image_wrist", proprio=PE.JOINT,
                    action=AE.JOINT_POS),
    "rh20t": _cfg(primary="image_front", secondary="image_side_right",
                  wrist="image_wrist", proprio=PE.POS_EULER),
    "mujoco_manip": _cfg(primary="image", proprio=PE.POS_EULER),
}
