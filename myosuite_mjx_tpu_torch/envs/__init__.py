"""Batched env suite: importing it registers the task ids."""
from myosuite_mjx_tpu_torch.envs import myobase  # noqa: F401  (registers IDs)
from myosuite_mjx_tpu_torch.envs import myochallenge  # noqa: F401
from myosuite_mjx_tpu_torch.envs import myodm  # noqa: F401
from myosuite_mjx_tpu_torch.envs.base import BatchedEnv, EnvState, MyoEnv
from myosuite_mjx_tpu_torch.envs.gym_adapter import (GymEnv, GymVecEnv,
                                                     gym_make)
from myosuite_mjx_tpu_torch.envs.registry import (
    make, register, register_env_variant, registry_ids)
