"""The "replay" kind: recorded trajectories replayed through the served
policy by one client in a closed loop (the next trajectory is sent when
the last one's actions are on the host).

The requests, instructions and frames come from perfbench/harness/
traffic.py (replay_order, replay_data). A request is one trajectory: the
episode's reset as eval/inference.py's InferenceWrapper.reset does it
(the frozen T5 encode of the instruction, `initial_state` of the first
frame, `create_tasks`, `prepare_serving_params` for the per-layer trunk),
then its frames in chunks of at most `chunk` (copied in from a pinned
host pool, resized and centre-cropped by ops/preprocess.py, acted on by
`sample_actions` on the per-layer trunk), each chunk's actions brought to
the host. What the action head computes before its decode (the mix
head's gripper logits) is kept beside the actions, for the check."""
import gc
import statistics
import time
from typing import Dict, List

import torch

from perfbench.harness import counts, faults, program, traffic, weights
from perfbench.reference.hypervla import HyperVLAReference, t5_shapes


def p95(values: List[float]) -> float:
    """The 95th percentile (statistics.quantiles' exclusive method; of a
    single value, that value)."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20)[18]


def keep_head_logits(model, kept: list) -> None:
    """Has the served policy's mix head append, at each call, the gripper
    logits it returns beside the arm (before the program's own decode) to
    `kept`. The head's call and decode stay the program's."""
    head = model.base_net.action_head
    base = type(head)

    class Keeping(base):
        def __call__(self, *args, **kwargs):
            out = base.__call__(self, *args, **kwargs)
            kept.append(out[1])
            return out

    head.__class__ = Keeping


class ReplayDriver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 wrap_step=None):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.ref = HyperVLAReference(cfg)
        self.instr_len = mix["instruction_tokens"]
        self.token_dim = cfg["t5"]["d_model"]
        self.wrap = wrap_step
        self.spans: Dict[str, list] = {}

    def layout(self):
        return weights.plan(
            self.ref.param_shapes(self.instr_len, self.token_dim),
            self.ref.blocks, self.ref.order, {"t5": t5_shapes(self.cfg["t5"])},
            self.cfg["t5"]["d_kv"])

    # -- set-up -----------------------------------------------------------

    def setup(self) -> None:
        import copy

        from hypervla_tpu_torch.eval.inference import initial_state
        from hypervla_tpu_torch.models.encoders.t5 import T5Config, t5_encode
        from hypervla_tpu_torch.ops import preprocess
        from hypervla_tpu_torch.ops.serving import prepare_serving_params

        mix, dev = self.mix, self.device
        w = weights.make(self.layout(), self.seed, dev)
        cfg = copy.deepcopy(self.cfg)
        cfg["config"]["base_net_kwargs"]["vit_kwargs"].update(
            mix["serving_switches"])
        self.model = program.build_model(cfg, w["params"], self.instr_len,
                                         self.token_dim, dev)
        self.t5 = w["t5"]
        t5cfg = T5Config(**self.cfg["t5"])
        self.ids, self.mask, pool = traffic.replay_data(mix, self.seed, dev)
        # the recorded frames live on the host, pinned, as a loader keeps
        # them
        self.pool = pool.cpu()
        if torch.device(dev).type == "cuda":
            self.pool = self.pool.pin_memory()
        del pool
        self.order = traffic.replay_order(mix, self.seed)
        side = mix["image_size"]
        model = self.model
        kept: list = []
        keep_head_logits(model, kept)

        sample = model.sample_actions
        if self.wrap is not None:
            sample = self.wrap(sample)

        def request(length, task, start, spans=None):
            """(actions (length, horizon, dim), gripper logits (length,
            horizon)), both on the host."""
            kept.clear()
            with torch.no_grad():
                mask = self.mask[task:task + 1]
                emb = t5_encode(t5cfg, self.t5, self.ids[task:task + 1],
                                mask)
                first = self.pool[start].to(dev, non_blocking=True)
                init = initial_state(model, first)
                instr = {"language_instruction": {"token_embedding": emb,
                                                  "attention_mask": mask}}
                if spans is not None:
                    events = [torch.cuda.Event(enable_timing=True)
                              for _ in range(2)]
                    events[0].record()
                base, task_dict = model.create_tasks(
                    instruction_dict=instr, initial_state=init)
                if spans is not None:
                    events[1].record()
                    spans.append(events)
                served = prepare_serving_params(model, base,
                                                stack_trunk=False)
                out = []
                for lo in range(0, length, mix["chunk"]):
                    n = min(mix["chunk"], length - lo)
                    frames = self.pool[start + lo:start + lo + n].to(
                        dev, non_blocking=True)
                    x = preprocess.center_crop(
                        preprocess.resize_image(frames, (side, side)),
                        (side, side))
                    act = sample(x, instr, task_dict, None, served,
                                 trunk_impl="layers")
                    out.append(act.cpu())
                # the last window step of each chunk, as the decode takes it
                logits = torch.cat([g[:, -1, :, 0] for g in kept]).cpu()
                return torch.cat(out), logits

        self.request = request
        self.answers_kept: Dict[int, tuple] = {}
        self.next = 0
        for length in mix["warmup_lengths"]:
            request(length, 0, 0)

    # -- the window -------------------------------------------------------

    def run(self, seconds: float, sync) -> dict:
        sync()
        t0 = time.perf_counter()
        latencies, frames = [], 0
        while True:
            i = self.next % len(self.order)
            t = time.perf_counter()
            self.serve(i)
            now = time.perf_counter()
            latencies.append(now - t)
            frames += self.order[i][0]
            self.next += 1
            if now - t0 >= seconds:
                break
        window = time.perf_counter() - t0
        metrics = {"actions_per_s": frames / window,
                   "request_ms_p95": 1e3 * p95(latencies)}
        return {"units": len(latencies), "failed": 0, "window_s": window,
                "metrics": metrics}

    def traced_requests(self) -> List[tuple]:
        return self.order[:self.mix["trace_units"]]

    def run_units(self, n: int) -> int:
        spans = None
        if torch.device(self.device).type == "cuda":
            spans = self.spans.setdefault("create_tasks", [])
            spans.clear()
        for i in range(n):
            self.serve(i, spans)
        return n

    def serve(self, i: int, spans=None) -> None:
        """Request i of the order; its answer is kept for the check."""
        self.answers_kept[i] = self.request(*self.order[i], spans)

    def work(self) -> dict:
        """The traced requests' operations by precision, their chunks, and
        the create_tasks spans (ms)."""
        reqs = self.traced_requests()
        flops = {"bfloat16": 0.0, "float32": 0.0}
        chunks = []
        for length, _, _ in reqs:
            for p, f in counts.replay_request(
                    self.cfg, self.ref.blocks, length,
                    self.instr_len).items():
                flops[p] += f
            chunks += [min(self.mix["chunk"], length - lo)
                       for lo in range(0, length, self.mix["chunk"])]
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        spans = [a.elapsed_time(b) for a, b in
                 self.spans.get("create_tasks", [])]
        return {"flops": flops, "chunks": chunks, "generate_ms": spans}

    def release(self) -> None:
        """Frees the program's state; the kept answers stay."""
        self.model = self.request = self.t5 = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------

    def sampled(self) -> List[int]:
        """The requests checked: the longest served, and more drawn from
        the seed, up to `checked_requests`."""
        done = sorted(self.answers_kept)
        longest = max(done, key=lambda i: self.order[i][0])
        gen = traffic.generator(self.seed, 3, "cpu")
        perm = torch.randperm(len(done), generator=gen).tolist()
        picked = [longest] + [done[j] for j in perm if done[j] != longest]
        return picked[:self.mix["checked_requests"]]

    def reference_outputs(self, picked, lower: bool = False):
        """{request: (arm, gripper logits)} of the reference (with
        `lower`, its control) on the picked requests."""
        ref = HyperVLAReference(self.cfg, lower=lower)
        w = weights.make(self.layout(), self.seed, self.device)
        ids, mask, pool = traffic.replay_data(self.mix, self.seed,
                                              self.device)
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out = {}
        try:
            for i in picked:
                length, task, start = self.order[i]
                out[i] = ref.serve(w["params"], w["t5"], ids[task],
                                   mask[task], pool[start],
                                   pool[start:start + length],
                                   self.mix["image_size"])
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        return out

    def readings(self) -> Dict[str, float]:
        picked = self.sampled()
        return compare(self.answers_kept, self.reference_outputs(picked),
                       picked)

    def control_answers(self, picked):
        """The control's answers in the program's form: the actions (the
        gripper decoded from the sign of its logit) and the logits."""
        out = {}
        for i, (arm, grip) in self.reference_outputs(picked, True).items():
            out[i] = (torch.cat([arm, (grip >= 0).float()[..., None]], -1),
                      grip)
        return out


def compare(answers, ref, picked) -> Dict[str, float]:
    """"arm": the largest gap of a served arm action from the reference's;
    "grip": the largest gap of a served gripper logit (before the decode)
    from the reference's."""
    arm_gap, grip_gap = 0.0, 0.0
    for i in picked:
        actions, logits = answers[i]
        arm, ref_logits = ref[i]
        served = actions.to(arm.device).float()
        arm_gap = max(arm_gap, float((served[..., :-1] - arm).abs().max()))
        grip_gap = max(grip_gap, float(
            (logits.to(arm.device).float() - ref_logits).abs().max()))
    return {"arm": arm_gap, "grip": grip_gap}


def calibrate(files, seed, control, fault_names, emit) -> None:
    """perfbench/calibrate.py's readings of one seed: the program's (a
    short window at the cell's load, then the check), with `control` the
    control's on the same requests, and each named fault's."""
    seconds = files["mix"]["calibrate_seconds"]
    kinds = [("program", None)] + [(f, faults.FAULTS[f])
                                   for f in fault_names]
    for kind, wrap in kinds:
        drv = ReplayDriver(files["config"], files["mix"], seed, "cuda",
                           wrap_step=wrap)
        drv.setup()
        window = drv.run(seconds, torch.cuda.synchronize)
        drv.release()
        picked = drv.sampled()
        t = time.perf_counter()
        ref = drv.reference_outputs(picked)
        emit({"seed": seed, "kind": kind,
              "readings": compare(drv.answers_kept, ref, picked),
              "requests": window["units"], "checked": len(picked),
              "frames_checked": sum(drv.order[i][0] for i in picked),
              "reference_s": time.perf_counter() - t})
        if control and kind == "program":
            t = time.perf_counter()
            emit({"seed": seed, "kind": "control",
                  "readings": compare(drv.control_answers(picked), ref,
                                      picked),
                  "control_s": time.perf_counter() - t})
        del drv
        gc.collect()
        torch.cuda.empty_cache()


Driver = ReplayDriver
