"""The "train" kind: hand-fed training steps of the program at the mix's
batch, the same state from the checked first steps through the window.

Set-up makes the weights and batches from the seed, builds the program's
step and state, and drives it through `checked_steps` steps (its warm-up,
which builds every kernel), keeping what the reference is held to: each
step's loss, each leaf's norm of the first step's gradient as the
optimizer got it (from AdamW's second moment, nu = (1 - b2) g^2 after one
update), and each leaf's change of the params and of their EMA after the
checked steps. The window goes on from that state."""
import gc
import math
import time
from typing import Dict

import torch

from perfbench.harness import counts, faults, program, traffic, weights
from perfbench.reference.hypervla import (
    HyperVLAReference,
    dino_shapes,
    gaps_by_leaf,
    t5_shapes,
)

B2 = 0.999


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in zip(tree, torch.stack(
        [t.detach().float().norm() for t in tree.values()]).cpu())}


class TrainDriver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 wrap_step=None):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.ref = HyperVLAReference(cfg)
        self.instr_len = mix["instruction_tokens"]
        self.token_dim = cfg["t5"]["d_model"]
        self.initial_image = bool(
            cfg["config"]["hypernet_kwargs"].get("use_initial_image"))
        self.wrap_step = wrap_step
        self.batch = mix["batch_size"]
        bk = cfg["config"]["base_net_kwargs"]
        self.action_shape = (bk["action_horizon"], bk["action_dim"])

    # -- set-up -----------------------------------------------------------

    def layout(self):
        frozen = {"t5": t5_shapes(self.cfg["t5"])}
        if self.initial_image:
            frozen["dino"] = dino_shapes(self.cfg["dinov2"], "")
        return weights.plan(
            self.ref.param_shapes(self.instr_len, self.token_dim),
            self.ref.blocks, self.ref.order, frozen, self.cfg["t5"]["d_kv"])

    def setup(self) -> None:
        mix = self.mix
        w = weights.make(self.layout(), self.seed, self.device)
        self.batches = [b["program"] for b in traffic.train_batches(
            mix, self.seed, self.device, self.initial_image,
            *self.action_shape)]
        step_fn, self.state, self.enc = program.build_train(
            self.cfg, w, self.instr_len, self.token_dim, mix["first_step"],
            self.seed, self.device)
        self.step_fn = (step_fn if self.wrap_step is None
                        else self.wrap_step(step_fn))
        initial = w["params"]
        self.k = 0
        self.losses = []
        for i in range(mix["checked_steps"]):
            info = self.step()
            self.losses.append(float(info["training_loss"]))
            if i == 0:
                nu = self.state.opt_state["nu"]
                sums = torch.stack([v.double().sum() for v in nu.values()])
                self.grad_norms = {k: math.sqrt(float(s) / (1 - B2))
                                   for k, s in zip(nu, sums.cpu())}
        self.changes = norms({k: self.state.params[k].detach() - initial[k]
                              for k in initial})
        ema = self.state.ema_params
        self.ema_changes = (None if ema is None else norms(
            {k: ema[k] - initial[k] for k in initial}))
        del w, initial

    def step(self):
        self.state, info = self.step_fn(
            self.state, self.batches[self.k % len(self.batches)],
            encoder_params=self.enc, with_metrics=False)
        self.k += 1
        return info

    # -- the window -------------------------------------------------------

    def run(self, seconds: float, sync) -> dict:
        """Steps back to back until `seconds` have passed; the window ends
        when the last step has finished on the card. The peak is the
        window's: torch.cuda.max_memory_allocated, reset at its start."""
        cuda = torch.device(self.device).type == "cuda"
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        n = 0
        while True:
            self.step()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        window = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        return {"units": n, "failed": 0, "window_s": window, "metrics": {
            "train_samples_per_s": n * self.batch / window,
            "train_peak_gib": peak / 2 ** 30}}

    def run_units(self, n: int) -> int:
        for _ in range(n):
            self.step()
        return n

    def work(self) -> dict:
        """What the per-layer readers count a step's work from."""
        return {"step_flops": counts.train_step(
            self.cfg, self.ref.blocks, self.batch, self.instr_len),
            "batch": self.batch}

    def release(self) -> None:
        self.state = self.step_fn = self.enc = self.batches = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------

    def reference(self, lower: bool = False) -> dict:
        """The reference's (with `lower`, its control's) side over the
        checked steps, from the same weights and batches."""
        mix = self.mix
        ref = HyperVLAReference(self.cfg, lower=lower)
        w = weights.make(self.layout(), self.seed, self.device)
        plain = [b["plain"] for b in traffic.train_batches(
            mix, self.seed, self.device, self.initial_image,
            *self.action_shape)]
        n = mix["checked_steps"]
        tf32 = torch.backends.cuda.matmul.allow_tf32
        cudnn_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            out = ref.train(w["params"], w["t5"], w.get("dino"),
                            [plain[i % len(plain)] for i in range(n)],
                            mix["first_step"], rows=mix["reference_rows"])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
        initial = w["params"]
        return {"losses": out["losses"], "grad_norms": out["grad_norms"],
                "changes": norms({k: out["params"][k] - initial[k]
                                  for k in initial}),
                "ema_changes": None if not self.cfg["config"].get(
                    "save_param_EMA") else norms(
                    {k: out["ema"][k] - initial[k] for k in initial})}

    def side(self) -> dict:
        """What the program kept of the checked steps."""
        return {"losses": self.losses, "grad_norms": self.grad_norms,
                "changes": self.changes, "ema_changes": self.ema_changes}

    def readings(self) -> Dict[str, float]:
        return compare(self.side(), self.reference())


def compare(side: dict, ref: dict, detail: bool = False) -> Dict:
    """Every number the check may compare (a cell's limits file names the
    ones it does): the relative loss gap of the first step ("loss1") and
    of the worst step ("loss"); and of the first step's gradient norm, of
    the params' change and of their EMA's change, the gap by leaf (the
    program's norm against the reference's, over the larger of the
    reference's norm of that leaf and of the median leaf) of the worst
    leaf ("grad", "change", "ema") and of the median leaf ("grad_median",
    ...). Leaves whose reference gradient is under a thousandth of the
    median leaf's are left out of the changes. With `detail`, also the
    worst leaves' names."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(side["losses"],
                                                 ref["losses"])]
    grads = ref["grad_norms"]
    median = sorted(grads.values())[len(grads) // 2]
    keep = {k: grads[k] >= 1e-3 * median for k in grads}
    result = {"loss1": gaps[0], "loss": max(gaps)}
    names = {}
    pairs = [("grad", "grad_norms", None), ("change", "changes", keep)]
    if ref["ema_changes"] is not None:
        pairs.append(("ema", "ema_changes", keep))
    for label, key, mask in pairs:
        worst, where, mid = gaps_by_leaf(side[key], ref[key], mask)
        result[label], result[label + "_median"] = worst, mid
        names[label] = where
    if detail:
        result["worst_leaves"] = names
        result["losses"] = [list(side["losses"]), list(ref["losses"])]
    return result


def calibrate(files, seed, control, fault_names, emit) -> None:
    """perfbench/calibrate.py's readings of one seed: the program's checked
    steps against the reference, each named fault's, and with `control`
    the control's (the reference in the next lower precision)."""
    kinds = [("program", None)] + [(f, faults.FAULTS[f])
                                   for f in fault_names]
    ref = None
    for kind, wrap in kinds:
        t = time.perf_counter()
        drv = TrainDriver(files["config"], files["mix"], seed, "cuda",
                          wrap_step=wrap)
        drv.setup()
        torch.cuda.synchronize()
        setup = time.perf_counter() - t
        side = drv.side()
        drv.release()
        t = time.perf_counter()
        if ref is None:
            ref = drv.reference()
        emit({"seed": seed, "kind": kind,
              "readings": compare(side, ref, True), "setup_s": setup,
              "reference_s": time.perf_counter() - t,
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
        del drv
        gc.collect()
        torch.cuda.empty_cache()
    if control:
        t = time.perf_counter()
        ctl = TrainDriver(files["config"], files["mix"], seed, "cuda")
        emit({"seed": seed, "kind": "control",
              "readings": compare(ctl.reference(lower=True), ref, True),
              "control_s": time.perf_counter() - t})
        del ctl
        gc.collect()
        torch.cuda.empty_cache()


Driver = TrainDriver
