"""Vectorized environment workers (counterpart of hypervla_tpu/eval/
venv.py; numpy only).

Tianshou-style parallel simulation for batched closed-loop evaluation:
DummyVectorEnv runs environments in-process; SubprocVectorEnv starts one
process per environment (the spawn context) with shared-memory observation
buffers, so images move without a copy between the simulator workers and
the policy's process. The environment factories cross the process boundary
through cloudpickle where it is installed (lambdas and closures), else
through pickle (functions and classes a child can import).
"""
import ctypes
import multiprocessing as mp
from typing import Any, Callable, List, Optional

import numpy as np

_NP_TO_CTYPE = {
    np.bool_: ctypes.c_bool,
    np.uint8: ctypes.c_uint8,
    np.int32: ctypes.c_int32,
    np.int64: ctypes.c_int64,
    np.float32: ctypes.c_float,
    np.float64: ctypes.c_double,
}


class ShArray:
    """Shared-memory ndarray wrapper used for zero-copy observation passing."""

    def __init__(self, dtype: np.dtype, shape: tuple, ctx=None):
        ctx = ctx or mp.get_context("spawn")
        self.arr = ctx.Array(
            _NP_TO_CTYPE[np.dtype(dtype).type], int(np.prod(shape))
        )
        self.dtype = np.dtype(dtype)
        self.shape = shape

    def save(self, ndarray: np.ndarray) -> None:
        assert isinstance(ndarray, np.ndarray)
        dst = self.arr.get_obj()
        dst_np = np.frombuffer(dst, dtype=self.dtype).reshape(self.shape)
        np.copyto(dst_np, ndarray)

    def get(self) -> np.ndarray:
        obj = self.arr.get_obj()
        return np.frombuffer(obj, dtype=self.dtype).reshape(self.shape)


def _setup_buf(space_sample, ctx=None) -> Any:
    """Builds a shared-memory mirror of an observation structure."""
    if isinstance(space_sample, dict):
        return {k: _setup_buf(v, ctx) for k, v in space_sample.items()}
    arr = np.asarray(space_sample)
    return ShArray(arr.dtype, arr.shape, ctx)


def _save_obs(buffer, obs) -> None:
    if isinstance(buffer, dict):
        for k in buffer:
            _save_obs(buffer[k], obs[k])
    else:
        buffer.save(np.asarray(obs))


def _load_obs(buffer):
    if isinstance(buffer, dict):
        return {k: _load_obs(v) for k, v in buffer.items()}
    return buffer.get().copy()


class _CloudpickleWrapper:
    """Lets lambdas/closures cross the spawn boundary (like tianshou)."""

    def __init__(self, fn):
        self.fn = fn

    def __getstate__(self):
        try:
            import cloudpickle
        except ImportError:
            import pickle as cloudpickle

        return cloudpickle.dumps(self.fn)

    def __setstate__(self, data):
        import pickle

        self.fn = pickle.loads(data)

    def __call__(self):
        return self.fn()


def _worker(parent_pipe, pipe, env_fn, obs_buffer):
    parent_pipe.close()
    env = env_fn()
    try:
        while True:
            cmd, data = pipe.recv()
            if cmd == "step":
                result = env.step(data)
                if len(result) == 5:
                    obs, reward, done, trunc, info = result
                else:
                    obs, reward, done, info = result
                    trunc = False
                if obs_buffer is not None:
                    _save_obs(obs_buffer, obs)
                    obs = None
                pipe.send((obs, reward, done, trunc, info))
            elif cmd == "reset":
                result = env.reset(**(data or {}))
                obs, info = result if isinstance(result, tuple) else (result, {})
                if obs_buffer is not None:
                    _save_obs(obs_buffer, obs)
                    obs = None
                pipe.send((obs, info))
            elif cmd == "render":
                pipe.send(env.render(**(data or {})))
            elif cmd == "getattr":
                pipe.send(getattr(env, data, None))
            elif cmd == "close":
                pipe.send(env.close() if hasattr(env, "close") else None)
                pipe.close()
                return
    except (EOFError, KeyboardInterrupt):
        pipe.close()


class DummyVectorEnv:
    """Sequential in-process vector env (debugging / single-core hosts)."""

    def __init__(self, env_fns: List[Callable]):
        self.envs = [fn() for fn in env_fns]

    def __len__(self):
        return len(self.envs)

    def reset(self, options: Optional[List[dict]] = None):
        results = [
            env.reset(**((options[i] if options else None) or {}))
            for i, env in enumerate(self.envs)
        ]
        obs, infos = zip(
            *[r if isinstance(r, tuple) else (r, {}) for r in results]
        )
        return list(obs), list(infos)

    def step(self, actions):
        results = [env.step(a) for env, a in zip(self.envs, actions)]
        padded = [r if len(r) == 5 else (*r[:3], False, r[3]) for r in results]
        obs, rewards, dones, truncs, infos = zip(*padded)
        return list(obs), list(rewards), list(dones), list(truncs), list(infos)

    def getattr(self, name: str):
        return [getattr(env, name, None) for env in self.envs]

    def close(self):
        for env in self.envs:
            if hasattr(env, "close"):
                env.close()


class SubprocVectorEnv:
    """One subprocess per environment, optional shared-memory observations."""

    def __init__(self, env_fns: List[Callable],
                 obs_sample: Optional[Any] = None):
        ctx = mp.get_context("spawn")
        self.n = len(env_fns)
        self.buffers = [
            _setup_buf(obs_sample, ctx) if obs_sample is not None else None
            for _ in range(self.n)
        ]
        self.pipes = []
        self.processes = []
        for env_fn, buf in zip(env_fns, self.buffers):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_worker,
                args=(parent, child, _CloudpickleWrapper(env_fn), buf),
                daemon=True,
            )
            proc.start()
            child.close()
            self.pipes.append(parent)
            self.processes.append(proc)

    def __len__(self):
        return self.n

    def reset(self, options: Optional[List[dict]] = None):
        for i, pipe in enumerate(self.pipes):
            pipe.send(("reset", options[i] if options else None))
        obs, infos = [], []
        for i, pipe in enumerate(self.pipes):
            o, info = pipe.recv()
            if o is None and self.buffers[i] is not None:
                o = _load_obs(self.buffers[i])
            obs.append(o)
            infos.append(info)
        return obs, infos

    def step(self, actions):
        for pipe, action in zip(self.pipes, actions):
            pipe.send(("step", action))
        obs, rewards, dones, truncs, infos = [], [], [], [], []
        for i, pipe in enumerate(self.pipes):
            o, r, d, t, info = pipe.recv()
            if o is None and self.buffers[i] is not None:
                o = _load_obs(self.buffers[i])
            obs.append(o)
            rewards.append(r)
            dones.append(d)
            truncs.append(t)
            infos.append(info)
        return obs, rewards, dones, truncs, infos

    def getattr(self, name: str):
        for pipe in self.pipes:
            pipe.send(("getattr", name))
        return [pipe.recv() for pipe in self.pipes]

    def close(self):
        for pipe in self.pipes:
            try:
                pipe.send(("close", None))
                pipe.recv()
            except (BrokenPipeError, EOFError):
                pass
        for proc in self.processes:
            proc.join(timeout=5)
            if proc.is_alive():
                proc.terminate()
