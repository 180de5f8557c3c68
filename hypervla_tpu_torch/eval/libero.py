"""LIBERO few-shot evaluator (counterpart of hypervla_tpu/eval/
libero.py).

Import-gated on the LIBERO benchmark package; also drives a remote policy
server like the SIMPLER evaluator. Protocol: 50 episodes per task with fixed
init states, a 520-step cap, success rates persisted as JSON. Episodes
reset without an initial state, so a model conditioned on the initial image
fails at reset (TypeError), in both packages.
"""
import argparse
import json
import logging
import os

import numpy as np

MAX_EPISODE_STEPS = 520
EPISODES_PER_TASK = 50

# the default location of the libero_90 split pickle
DEFAULT_SPLIT_FILE = "octo/domains/LIBERO/task_split.pkl"


def resolve_task_ids(
    suite,
    benchmark_name: str,
    split=None,
    split_file: str = DEFAULT_SPLIT_FILE,
    model_path: str = "",
    task_ids=None,
):
    """Task selection incl. the libero_90 train/test split protocol.

    The split pickle
    holds (train_task_names, test_task_names); each name carries a 10-char
    demo-file suffix that is stripped before lookup in the suite's task-name
    list. split='single_task' selects the one task named by the third path
    component of the fine-tune directory (its naming convention). Any other suite, or split=None, runs every task.
    Explicit task_ids always win (raw mechanism, kept for scripting).
    """
    if task_ids is not None:
        return list(task_ids)
    n_tasks = suite.n_tasks
    if benchmark_name == "libero_90" and split is not None:
        names = [suite.get_task(i).name for i in range(n_tasks)]
        if split == "single_task":
            task_name = model_path.split("/")[2]
            return [names.index(task_name)]
        import pickle

        with open(split_file, "rb") as f:
            train_names, test_names = pickle.load(f)
        chosen = train_names if "train" in split else test_names
        return [names.index(name[:-10]) for name in chosen]
    return list(range(n_tasks))


def evaluate(
    policy,
    text_encode,
    benchmark_name: str = "libero_object",
    seed: int = 0,
    eval_path: str = "eval_results/libero",
    recompute: bool = False,
    num_episodes: int = EPISODES_PER_TASK,
    task_ids=None,
    split=None,
    split_file: str = DEFAULT_SPLIT_FILE,
    model_path: str = "",
):
    from libero.libero import benchmark, get_libero_path
    from libero.libero.envs import OffScreenRenderEnv

    os.makedirs(eval_path, exist_ok=True)
    results_file = os.path.join(eval_path, f"{benchmark_name}.json")
    results = {}
    if os.path.exists(results_file):
        with open(results_file) as f:
            results = json.load(f)

    benchmark_dict = benchmark.get_benchmark_dict()
    suite = benchmark_dict[benchmark_name]()
    task_ids = resolve_task_ids(
        suite, benchmark_name, split=split, split_file=split_file,
        model_path=model_path, task_ids=task_ids,
    )

    for task_id in task_ids:
        task = suite.get_task(task_id)
        task_name = task.name
        if task_name in results and not recompute:
            continue
        task_description = task.language
        task_bddl = os.path.join(
            get_libero_path("bddl_files"), task.problem_folder, task.bddl_file
        )
        env = OffScreenRenderEnv(
            bddl_file_name=task_bddl, camera_heights=256, camera_widths=256
        )
        init_states = suite.get_task_init_states(task_id)

        successes = []
        for episode in range(num_episodes):
            env.reset()
            env.seed(seed + episode)
            obs = env.set_init_state(
                init_states[episode % init_states.shape[0]]
            )
            image = obs["agentview_image"][::-1]  # flip to upright

            if text_encode is not None:
                instruction_dict = text_encode(task_description)
                policy.reset(task_description, instruction_dict)
            else:
                policy.reset(task_description)

            success = False
            for _ in range(MAX_EPISODE_STEPS):
                if text_encode is not None:
                    _, action, _, _, _ = policy.step(image)
                else:
                    action = policy.step(image)["action"]
                obs, reward, done, info = env.step(action)
                image = obs["agentview_image"][::-1]
                if done:
                    success = True
                    break
            successes.append(float(success))
            logging.info(f"{task_name} ep {episode}: success={success}")
        env.close()
        results[task_name] = float(np.mean(successes))
        with open(results_file, "w") as f:
            json.dump(results, f)
    return results


def main():
    parser = argparse.ArgumentParser(description="LIBERO few-shot evaluation")
    parser.add_argument("--model_path", type=str, default="")
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--benchmark", type=str, default="libero_object")
    parser.add_argument("--seeds", type=str, default="0")
    parser.add_argument("--action_ensemble", action="store_true")
    parser.add_argument("--recompute", action="store_true")
    parser.add_argument("--EMA", type=float, default=0.999)
    parser.add_argument("--policy_server", type=str, default=None)
    parser.add_argument("--split", type=str, default="train",
                        help="libero_90 split: train / test / single_task "
                             "(only consulted for the libero_90 suite)")
    parser.add_argument("--split_file", type=str, default=DEFAULT_SPLIT_FILE)
    args = parser.parse_args()

    for seed in [int(s) for s in args.seeds.split("+")]:
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
                policy_setup="libero",
                action_ensemble=args.action_ensemble,
                ema_decay=args.EMA,
            )
            text_encode = build_text_encoder(policy.model)
        evaluate(
            policy,
            text_encode,
            benchmark_name=args.benchmark,
            seed=seed,
            eval_path=f"eval_results/libero/{seed}",
            recompute=args.recompute,
            split=args.split,
            split_file=args.split_file,
            model_path=args.model_path,
        )


if __name__ == "__main__":
    main()
