"""The one generator of every traffic mix: a mix file (perfbench/traffic/
<name>.json) gives its kind and parameters, and the seed gives the
values, made on the device in a few large draws.

Kinds:
  * "train": hand-fed training batches, `distinct_batches` of them made at
    set-up and cycled; each row its own frames, instruction and actions;
  * "replay": trajectories replayed through the served policy by a closed
    loop of one client; each has an instruction of a pool, a first frame
    and frames of a frame pool, and a length of the mix's cycle of
    lengths, which the seed orders.
"""
from typing import List

import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator of its own for each stream of one seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def instructions(n: int, mix: dict, gen, device):
    """(ids (n, L) int64, attention mask (n, L) int64): lengths uniform over
    mix["instruction_length"], ids over mix["token_ids"], padding id 0."""
    length = mix["instruction_tokens"]
    lo, hi = mix["instruction_length"]
    lengths = torch.randint(lo, hi + 1, (n, 1), generator=gen, device=device)
    ids = torch.randint(mix["token_ids"][0], mix["token_ids"][1], (n, length),
                        generator=gen, device=device)
    mask = (torch.arange(length, device=device)[None] < lengths).long()
    return ids * mask, mask


def frames(n: int, side: int, gen, device):
    return torch.randint(0, 256, (n, side, side, 3), generator=gen,
                         device=device, dtype=torch.uint8)


def actions(n: int, mix: dict, horizon: int, dim: int, gen, device):
    """(n, horizon, dim) actions: arm dims N(0, arm_std), the last dim a
    gripper state of 0 or 1."""
    act = torch.randn(n, horizon, dim, generator=gen, device=device)
    act[..., :-1] *= mix["arm_std"]
    act[..., -1] = (act[..., -1] > 0).float()
    return act


def train_batches(mix: dict, seed: int, device, initial_image: bool,
                  horizon: int, dim: int) -> List[dict]:
    """The mix's distinct batches in the program's batch layout, and beside
    it (under "plain") the same values for the reference."""
    out = []
    b, side = mix["batch_size"], mix["image_size"]
    for i in range(mix["distinct_batches"]):
        gen = generator(seed, i, device)
        ids, mask = instructions(b, mix, gen, device)
        images = frames(b, side, gen, device)
        initial = frames(b, side, gen, device) if initial_image else None
        act = actions(b, mix, horizon, dim, gen, device)
        batch = {
            "observation": {
                "image_primary": images[:, None],
                "timestep_pad_mask": torch.ones(b, 1, dtype=torch.bool,
                                                device=device)},
            "task": {
                "language_instruction": {"input_ids": ids,
                                         "attention_mask": mask},
                "pad_mask_dict": {"language_instruction": torch.ones(
                    b, dtype=torch.bool, device=device)}},
            "action": act[:, None],
            "action_pad_mask": torch.ones_like(act[:, None],
                                               dtype=torch.bool),
        }
        if initial_image:
            batch["initial_state"] = {"image_primary": initial[:, None]}
        out.append({"program": batch, "plain": {
            "ids": ids, "mask": mask, "images": images, "initial": initial,
            "actions": act}})
    return out


def replay_order(mix: dict, seed: int) -> List[tuple]:
    """(length, instruction index, pool offset) of every request, in the
    order the client sends them: `cycles` cycles, each the mix's
    `lengths` in an order of its own, with instructions and offsets drawn
    from the seed."""
    lengths = list(mix["lengths"])
    gen = generator(seed, 1, "cpu")
    out = []
    for _ in range(mix["cycles"]):
        perm = torch.randperm(len(lengths), generator=gen).tolist()
        tasks = torch.randint(0, mix["instruction_pool"], (len(perm),),
                              generator=gen).tolist()
        starts = torch.randint(0, mix["frame_pool"], (len(perm),),
                               generator=gen).tolist()
        out += [(lengths[p], t, s) for p, t, s in zip(perm, tasks, starts)]
    return out


def replay_data(mix: dict, seed: int, device):
    """(instruction ids, masks) of the instruction pool and the frame pool
    (frame_pool + the longest length frames, so that a trajectory starting
    anywhere in the first frame_pool never wraps), made on `device`."""
    gen = generator(seed, 2, device)
    ids, mask = instructions(mix["instruction_pool"], mix, gen, device)
    pool = frames(mix["frame_pool"] + max(mix["lengths"]), mix["frame_size"],
                  gen, device)
    return ids, mask, pool
