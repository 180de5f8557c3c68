"""SIMPLER closed-loop evaluator (counterpart of hypervla_tpu/eval/
simpler.py).

Import-gated: the SIMPLER/ManiSkill2 simulators may not install beside the
policy, so this module (a) runs locally when `simpler_env` is importable,
or (b) drives a remote policy server (eval/policy_server.py) from the
simulator machine with `--policy_server host:port`.

Task table (episode counts) of the zero-shot protocol: 3 drawer tasks x20,
pick x50, move_near x60, 4 WidowX tasks x20.

`_initial_state` encodes an episode's first frame for a model conditioned
on the initial image with a DINOv2 of its own, fp32, as the JAX evaluator
does: not the model's shared (and possibly fine-tuned) trunk. Its weights
are `$HYPERVLA_PRETRAINED_DIR/<name>.pt` where that file exists
(models/encoders/pretrained.py::load_dinov2_weights), else drawn from seed
0: the JAX package then draws them from PRNGKey(0), which a
torch.Generator cannot reproduce, so the two packages agree only on loaded
weights. A reset without an initial state (the remote mode's client sends
none) fails on such a model, in both packages, with a TypeError.
"""
import argparse
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from hypervla_tpu_torch.configs import dinov2_config
from hypervla_tpu_torch.models.base_vit import RESOLUTION, normalize_pixels
from hypervla_tpu_torch.models.encoders.dinov2 import (
    dinov2_forward,
    dinov2_specs,
)
from hypervla_tpu_torch.models.encoders.pretrained import load_dinov2_weights
from hypervla_tpu_torch.models.layers import init_params
from hypervla_tpu_torch.ops import preprocess

SIMPLER_TASKS = {
    "google_robot_close_top_drawer": (None, 20, None),
    "google_robot_close_middle_drawer": (None, 20, None),
    "google_robot_close_bottom_drawer": (None, 20, None),
    "google_robot_pick_object": (None, 50, None),
    "google_robot_move_near": (
        None,
        60,
        [{"obj_init_options": {"episode_id": i}} for i in range(60)],
    ),
    "widowx_spoon_on_towel": (None, 20, None),
    "widowx_carrot_on_plate": (None, 20, None),
    "widowx_stack_cube": (None, 20, None),
    "widowx_put_eggplant_in_basket": (None, 20, None),
}


def policy_setup_for_task(task_name: str) -> str:
    return "google_robot" if "google_robot" in task_name else "widowx_bridge"


def evaluate(
    policy,
    text_encode,
    tasks=SIMPLER_TASKS,
    seed: int = 0,
    eval_path: str = "eval_results/simpler",
    save_file_name: str = "success_rate",
    save_video: bool = False,
    recompute: bool = False,
    max_steps_override: Optional[int] = None,
    save_attention_map: bool = False,
):
    """Runs the closed-loop SIMPLER evaluation.

    policy: InferenceWrapper-like object (reset/step) OR a PolicyClient.
    text_encode: str -> instruction dict (ignored for PolicyClient).
    """
    import simpler_env
    from simpler_env.utils.env.observation_utils import (
        get_image_from_maniskill2_obs_dict,
    )

    os.makedirs(eval_path, exist_ok=True)
    results_file = os.path.join(eval_path, f"{save_file_name}.json")
    all_tasks_success_rate = {}
    if os.path.exists(results_file):
        with open(results_file) as f:
            all_tasks_success_rate = json.load(f)

    for task_name, (_, num_episodes, task_options) in tasks.items():
        if task_name in all_tasks_success_rate and not recompute:
            continue
        env = simpler_env.make(task_name)
        successes = []
        inference_times = []
        sim_times = []
        for episode in range(num_episodes):
            options = (
                task_options[episode % len(task_options)]
                if task_options
                else None
            )
            obs, reset_info = env.reset(
                seed=seed + episode, options=options or {}
            )
            instruction = env.get_language_instruction()
            image = get_image_from_maniskill2_obs_dict(env, obs)

            if hasattr(policy, "reset") and text_encode is not None:
                instruction_dict = text_encode(instruction)
                initial_state = _initial_state(policy, image)
                policy.reset(instruction, instruction_dict,
                             initial_state=initial_state)
            else:  # PolicyClient
                policy.reset(instruction)

            done, truncated = False, False
            success = False
            steps = 0
            frames = [image] if save_video else None
            attention_maps = [] if save_attention_map else None
            max_steps = max_steps_override or env.spec.max_episode_steps or 300
            while not (done or truncated) and steps < max_steps:
                t0 = time.time()
                if hasattr(policy, "step") and text_encode is not None:
                    _, action, _, attn, model_time = policy.step(image)
                    inference_times.append(model_time)
                    if attention_maps is not None and attn is not None:
                        attention_maps.append(np.asarray(attn))
                else:
                    reply = policy.step(image)
                    action = reply["action"]
                    inference_times.append(reply["model_time"])
                t1 = time.time()
                obs, reward, done, truncated, info = env.step(action)
                sim_times.append(time.time() - t1)
                image = get_image_from_maniskill2_obs_dict(env, obs)
                if frames is not None:
                    frames.append(image)
                success = success or bool(done)
                steps += 1
            successes.append(float(success))
            if frames is not None:
                _write_video(
                    os.path.join(
                        eval_path,
                        f"{task_name}_ep{episode}_{'succ' if success else 'fail'}",
                    ),
                    frames,
                )
            if attention_maps:
                # the episode's attention maps, pickled
                import pickle

                with open(
                    os.path.join(
                        eval_path, f"{task_name}_ep{episode}_attention.pkl"
                    ),
                    "wb",
                ) as f:
                    pickle.dump(np.stack(attention_maps), f)
            logging.info(
                f"{task_name} ep {episode}: success={success} "
                f"(avg model {np.mean(inference_times)*1000:.1f} ms, "
                f"sim {np.mean(sim_times)*1000:.1f} ms)"
            )
        env.close()
        all_tasks_success_rate[task_name] = float(np.mean(successes))
        with open(results_file, "w") as f:
            json.dump(all_tasks_success_rate, f)
    return all_tasks_success_rate


def _write_video(path_base: str, frames):
    """Saves rollout frames as an MP4 through mediapy or imageio where
    one is installed (with an ffmpeg backend), else a PIL GIF, else a .npz
    dump."""
    arr = np.stack([np.asarray(f) for f in frames])
    try:
        import mediapy

        mediapy.write_video(path_base + ".mp4", arr, fps=10)
        return
    except Exception:  # missing package or no ffmpeg backend
        pass
    try:
        import imageio

        imageio.mimsave(path_base + ".mp4", arr, fps=10)
        return
    except Exception:
        pass
    try:
        from PIL import Image

        imgs = [Image.fromarray(f) for f in arr]
        imgs[0].save(
            path_base + ".gif", save_all=True, append_images=imgs[1:],
            duration=100, loop=0,
        )
        return
    except ImportError:
        np.savez_compressed(path_base + ".npz", frames=arr)


def initial_image_encoder(name: str, device):
    """(config, params) of the separate DINOv2 `name` that _initial_state
    encodes with: the pretrained weights where load_dinov2_weights finds
    them, else drawn from seed 0 on `device`."""
    config = dinov2_config(name)
    params = load_dinov2_weights(name, device=device)
    if params is None:
        params = {k[len("dino/"):]: v for k, v in init_params(
            dinov2_specs(config, "dino"), 0, device).items()}
    return config, params


def _initial_state(policy, image):
    """The initial-state dict (resized first frame and its DINOv2 last
    hidden state, CLS and patches) when the model conditions on the initial
    image, else None. The encoder is the separate fp32 DINOv2 of the module
    docstring, built once per policy on the model's device."""
    model = getattr(policy, "model", None)
    if model is None or not model.config["hypernet_kwargs"].get(
            "use_initial_image", False):
        return None
    name = model.config["base_net_kwargs"]["vit_kwargs"].get(
        "pretrained_encoder_name", "dinov2-base")
    device = model.device
    if not hasattr(policy, "_dino_encode"):
        config, params = initial_image_encoder(name, device)

        @torch.no_grad()
        def encode(images):
            return dinov2_forward(config, params, normalize_pixels(images))

        policy._dino_encode = encode

    resized = preprocess.resize_image(torch.as_tensor(image, device=device),
                                      (RESOLUTION, RESOLUTION))
    patches = policy._dino_encode(resized[None])
    return {
        "image_primary": resized[None, None].cpu().numpy(),
        "patch_embeddings": patches.cpu().numpy(),
    }


def main():
    parser = argparse.ArgumentParser(description="SIMPLER zero-shot evaluation")
    parser.add_argument(
        "--model",
        choices=["hypervla", "base_net", "octo"],
        default="hypervla",
    )
    parser.add_argument("--model_path", type=str, default="")
    parser.add_argument("--seeds", type=str, default="0+1+2+3")
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--action_ensemble", action="store_true")
    parser.add_argument("--save_video", action="store_true")
    parser.add_argument("--save_attention_map", action="store_true")
    parser.add_argument("--recompute", action="store_true")
    parser.add_argument("--window_size", type=int, default=2)
    parser.add_argument("--crop", action="store_true")
    parser.add_argument("--EMA", type=float, default=None)
    parser.add_argument(
        "--policy_server",
        type=str,
        default=None,
        help="host:port of a policy server; when set, the model "
        "runs remotely and this process only drives the simulator",
    )
    args = parser.parse_args()

    seeds = [int(s) for s in args.seeds.split("+")]
    for seed in seeds:
        if args.policy_server:
            from hypervla_tpu_torch.eval.policy_server import PolicyClient

            host, port = args.policy_server.split(":")
            policy = PolicyClient(host, int(port))
            text_encode = None
        else:
            from hypervla_tpu_torch.eval.model_loading import (
                build_text_encoder,
                load_hypervla_policy,
            )

            policy = load_hypervla_policy(
                args.model_path,
                step=args.step,
                action_ensemble=args.action_ensemble,
                crop=args.crop,
                ema_decay=args.EMA,
                horizon=args.window_size,
            )
            text_encode = build_text_encoder(policy.model)
        evaluate(
            policy,
            text_encode,
            seed=seed,
            eval_path=f"eval_results/simpler/{args.model}/{seed}",
            recompute=args.recompute,
            save_attention_map=args.save_attention_map,
            save_video=args.save_video,
        )


if __name__ == "__main__":
    main()
