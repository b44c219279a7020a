"""Vector envs with gymnasium's ``SAME_STEP`` autoreset, without gymnasium
(the ``sync`` and ``async`` backends of ``sheeprl_tpu/envs/factory.py::
build_vector_env``, which uses ``gym.vector.SyncVectorEnv`` and
``AsyncVectorEnv``).

``step(actions)`` steps env ``i`` with ``actions[i]``; an env whose episode
ends is reset in the same call, its last observation and info go to
``infos["final_obs"]`` (an object array, None elsewhere) and
``infos["final_info"]``, and the batch holds the reset observation. Infos
are batched as gymnasium batches them (``_add_info``): each key an array
over the envs with a boolean ``_key`` mask, dicts recursively, so
``infos["final_info"]["episode"]["r"]`` with ``["_r"]`` and
``infos["restart_on_exception"]`` read as the JAX main reads them.
Observations are batched on a leading axis (a dict of arrays for a
``Dict`` space), rewards are float64, the flags bool.

``AsyncVectorEnv`` runs each env in its own ``spawn``ed process and talks
to it over a pipe. The workers run on the CPU: they start with
``CUDA_VISIBLE_DEVICES`` empty and ``OMP_NUM_THREADS=1``, and a worker
whose env imported torch sets it to one thread.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import sys
import traceback
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from sheeprl_tpu_torch.envs import spaces

Seeds = Union[None, int, Sequence[Optional[int]]]


def concatenate(space: spaces.Space, items: Sequence[Any]) -> Any:
    """The observations of ``items`` batched on a leading env axis."""
    if isinstance(space, spaces.Dict):
        return {k: concatenate(s, [o[k] for o in items]) for k, s in space.items()}
    return np.stack([np.asarray(o) for o in items])


class VectorEnv:
    """``num_envs`` envs stepped as one; the single env's spaces are
    ``single_observation_space`` and ``single_action_space``."""

    num_envs: int
    single_observation_space: spaces.Space
    single_action_space: spaces.Space
    closed = False

    def _seeds(self, seed: Seeds) -> List[Optional[int]]:
        if seed is None:
            return [None] * self.num_envs
        if isinstance(seed, int):
            return [seed + i for i in range(self.num_envs)]
        if len(seed) != self.num_envs:
            raise ValueError(f"If seeds are passed as a list the length must match num_envs={self.num_envs} but got length={len(seed)}.")
        return list(seed)

    def _add_info(self, vector_infos: Dict[str, Any], env_info: Dict[str, Any], env_num: int) -> Dict[str, Any]:
        """gymnasium's ``VectorEnv._add_info``: ``env_info`` of env
        ``env_num`` into the batched infos, with a ``_key`` mask per key."""
        for key, value in env_info.items():
            if key == "final_obs":
                array = vector_infos["final_obs"] if "final_obs" in vector_infos else np.full(self.num_envs, None, dtype=object)
                array[env_num] = value
            elif isinstance(value, dict):
                array = self._add_info(vector_infos.get(key, {}), value, env_num)
            else:
                if key not in vector_infos:
                    if type(value) in (int, float, bool) or issubclass(type(value), np.number):
                        array = np.zeros(self.num_envs, dtype=type(value))
                    elif isinstance(value, np.ndarray):
                        array = np.zeros((self.num_envs, *value.shape), dtype=value.dtype)
                    else:
                        array = np.full(self.num_envs, None, dtype=object)
                else:
                    array = vector_infos[key]
                array[env_num] = value
            mask = vector_infos.get(f"_{key}", np.zeros(self.num_envs, dtype=np.bool_))
            mask[env_num] = True
            vector_infos[key], vector_infos[f"_{key}"] = array, mask
        return vector_infos

    def _batch_step(self, results: Sequence[Tuple[Any, ...]]) -> Tuple[Any, np.ndarray, np.ndarray, np.ndarray, Dict[str, Any]]:
        infos: Dict[str, Any] = {}
        for i, (*_, info) in enumerate(results):
            infos = self._add_info(infos, info, i)
        return (
            concatenate(self.single_observation_space, [r[0] for r in results]),
            np.array([r[1] for r in results], np.float64),
            np.array([r[2] for r in results], np.bool_),
            np.array([r[3] for r in results], np.bool_),
            infos,
        )

    def __del__(self) -> None:
        if not getattr(self, "closed", True):
            self.close()


def _same_step(env: Any, action: Any) -> Tuple[Any, float, bool, bool, Dict[str, Any]]:
    """One env step with ``SAME_STEP`` autoreset: the final observation and
    info of an ended episode ride in the info of the reset."""
    obs, reward, terminated, truncated, info = env.step(action)
    if terminated or truncated:
        reset_obs, reset_info = env.reset()
        info = {"final_info": info, "final_obs": obs, **reset_info}
        obs = reset_obs
    return obs, reward, terminated, truncated, info


class SyncVectorEnv(VectorEnv):
    """The envs in this process, stepped in turn."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]]) -> None:
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        self.closed = False

    def reset(self, *, seed: Seeds = None, options: Optional[Dict[str, Any]] = None) -> Tuple[Any, Dict[str, Any]]:
        obs, infos = [], {}
        for i, (env, s) in enumerate(zip(self.envs, self._seeds(seed))):
            o, info = env.reset(seed=s, options=options)
            obs.append(o)
            infos = self._add_info(infos, info, i)
        return concatenate(self.single_observation_space, obs), infos

    def step(self, actions: Any) -> Tuple[Any, np.ndarray, np.ndarray, np.ndarray, Dict[str, Any]]:
        return self._batch_step([_same_step(env, actions[i]) for i, env in enumerate(self.envs)])

    def close(self) -> None:
        if not self.closed:
            # a constructor that raised leaves no envs to close
            for env in getattr(self, "envs", ()):
                env.close()
            self.closed = True


def _worker(index: int, env_fn: Callable[[], Any], pipe: Any, parent_pipe: Any) -> None:
    """An async env's process: builds the env, then serves ``reset``,
    ``step``, ``spaces`` and ``close`` until ``close``."""
    parent_pipe.close()
    env = None
    try:
        env = env_fn()
        if "torch" in sys.modules:  # a torch env (the pixel twins): one thread
            sys.modules["torch"].set_num_threads(1)
        while True:
            command, data = pipe.recv()
            if command == "reset":
                pipe.send((env.reset(**data), True))
            elif command == "step":
                pipe.send((_same_step(env, data), True))
            elif command == "spaces":
                pipe.send(((env.observation_space, env.action_space), True))
            elif command == "close":
                pipe.send((None, True))
                break
            else:
                raise RuntimeError(f"unknown command {command!r}")
    except (KeyboardInterrupt, EOFError, BrokenPipeError):
        pass
    except Exception:
        with contextlib.suppress(BrokenPipeError, OSError):
            pipe.send((f"env {index}: {traceback.format_exc()}", False))
    finally:
        if env is not None:
            env.close()
        pipe.close()


# the environment of a worker process: no CUDA card, one OpenMP thread
_WORKER_ENVIRON = {"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}


@contextlib.contextmanager
def _cpu_only_children() -> Iterator[None]:
    """Processes started in this block see no CUDA card and run one OpenMP
    thread."""
    saved = {k: os.environ.get(k) for k in _WORKER_ENVIRON}
    os.environ.update(_WORKER_ENVIRON)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class AsyncVectorEnv(VectorEnv):
    """Each env in a ``spawn``ed process of its own, over a pipe. The env
    thunks must pickle (``make_env`` returns ones that do)."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]], timeout: float = 300.0) -> None:
        ctx = mp.get_context("spawn")
        self.num_envs = len(env_fns)
        self.timeout = timeout
        self.closed = False
        self.parent_pipes, self.processes = [], []
        with _cpu_only_children():
            for index, env_fn in enumerate(env_fns):
                parent, child = ctx.Pipe()
                process = ctx.Process(
                    target=_worker, name=f"AsyncVectorEnv-Worker-{index}", args=(index, env_fn, child, parent), daemon=True
                )
                self.parent_pipes.append(parent)
                self.processes.append(process)
                process.start()
                child.close()
        try:
            self.single_observation_space, self.single_action_space = self._call([("spaces", None)])[0]
        except BaseException:
            self.close(terminate=True)
            raise

    def _call(self, commands: Sequence[Tuple[str, Any]]) -> List[Any]:
        """Send command ``i`` to worker ``i`` (one command to every worker
        when given one) and gather the replies in order."""
        pipes = self.parent_pipes[: len(commands)]
        for pipe, command in zip(pipes, commands):
            pipe.send(command)
        results, errors = [], []
        for index, pipe in enumerate(pipes):
            if not pipe.poll(self.timeout):
                errors.append(f"env {index}: no reply in {self.timeout} s")
                continue
            try:
                payload, ok = pipe.recv()
            except (EOFError, OSError):
                errors.append(f"env {index}: its process exited")
                continue
            (results if ok else errors).append(payload)
        if errors:
            raise RuntimeError("AsyncVectorEnv worker failed:\n" + "\n".join(errors))
        return results

    def reset(self, *, seed: Seeds = None, options: Optional[Dict[str, Any]] = None) -> Tuple[Any, Dict[str, Any]]:
        results = self._call([("reset", {"seed": s, "options": options}) for s in self._seeds(seed)])
        infos: Dict[str, Any] = {}
        for i, (_, info) in enumerate(results):
            infos = self._add_info(infos, info, i)
        return concatenate(self.single_observation_space, [o for o, _ in results]), infos

    def step(self, actions: Any) -> Tuple[Any, np.ndarray, np.ndarray, np.ndarray, Dict[str, Any]]:
        return self._batch_step(self._call([("step", actions[i]) for i in range(self.num_envs)]))

    def close(self, terminate: bool = False) -> None:
        if self.closed:
            return
        self.closed = True
        if not terminate:
            for pipe, process in zip(self.parent_pipes, self.processes):
                if process.is_alive():
                    with contextlib.suppress(BrokenPipeError, OSError):
                        pipe.send(("close", None))
            for pipe, process in zip(self.parent_pipes, self.processes):
                with contextlib.suppress(EOFError, OSError):
                    if pipe.poll(self.timeout):
                        pipe.recv()
        for process in self.processes:
            process.join(timeout=5 if not terminate else 0)
            if process.is_alive():
                process.terminate()
                process.join()
        for pipe in self.parent_pipes:
            pipe.close()
