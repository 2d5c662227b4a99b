"""Data-parallel training over ``torch.distributed``.

Counterpart of ``myosuite_mjx_tpu/parallel/mesh.py``, where one program
runs on a device mesh with a ``data`` axis and XLA inserts the
all-reduces. Here each process (one per card, or per CPU worker with the
``gloo`` backend) holds B / world envs and a replica of the learner, and
the learners' batch reductions (``train/common.BatchReductions``) cross
processes:

- the advantage statistics, NPG's over the whole batch and PPO's per
  minibatch;
- the ``RunningNorm`` updates of the obs (and PPO's return) statistics;
- NPG's policy gradient and every Fisher-vector product of its conjugate
  gradient; PPO's minibatch gradients, averaged before the clip (each
  process holds ``data_groups / world`` of the shuffle groups, so the
  permutations stay local);
- NPG's value fit runs on the whole batch (small: N*T samples of obs,
  time feature, target and live mask), gathered to every process, so
  the baseline stays replicated.

Given the global action noise and permutations (``train_step_from``), a
step equals the single-process step up to the order of the reductions;
each process reduces its share with the plain learner's own calls before
the collectives, so one process takes the plain step exactly.
``train_step(state, generator)`` draws them from ``generator``, which
every process seeds alike. The env draws of a rollout (resets of tasks
that draw) come from that generator in one process and from a generator
of the process's own elsewhere, so tasks whose resets draw take other
numbers than in one process.

The backend is ``nccl`` for CUDA tensors and ``gloo`` for CPU ones. NCCL
puts one process on one card.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from myosuite_mjx_tpu_torch.train.common import BatchReductions
from myosuite_mjx_tpu_torch.train.npg import NPG, NPGState
from myosuite_mjx_tpu_torch.train.ppo import PPO, TrainState


def init_distributed(address: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None, device="cuda") -> bool:
  """Join the process group; returns True for more than one process.

  The configuration comes from the arguments, else from the environment
  ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``). With neither, there is one process and nothing to join:
  returns False. A configuration that is there but incomplete raises,
  and so does a failed join: a misconfigured launch must not train in
  one process silently. The backend follows ``device``: ``nccl`` for the
  card, ``gloo`` for the CPU.
  """
  if dist.is_initialized():
    return dist.get_world_size() > 1
  env = os.environ
  configured = (address is not None or (world_size or 0) > 1
                or "MASTER_ADDR" in env or "WORLD_SIZE" in env)
  if not configured:
    return False
  if address is None:
    if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
      raise ValueError("no address: pass one, or set MASTER_ADDR and "
                       "MASTER_PORT")
    address = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
  if world_size is None:
    if "WORLD_SIZE" not in env:
      raise ValueError("no world size: pass one, or set WORLD_SIZE")
    world_size = int(env["WORLD_SIZE"])
  if rank is None:
    if "RANK" not in env:
      raise ValueError("no rank: pass one, or set RANK")
    rank = int(env["RANK"])
  if not 0 <= rank < world_size:
    raise ValueError(f"rank {rank} is not in a world of {world_size}")
  backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
  dist.init_process_group(backend, init_method=address,
                          world_size=world_size, rank=rank)
  return dist.get_world_size() > 1


@dataclasses.dataclass(frozen=True)
class DataMesh:
  """The process group the env batch is split over (``None``: this
  process alone, no collectives), its size and this process's rank."""
  group: object
  world: int
  rank: int

  def all_sum(self, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the processes (a new tensor)."""
    if self.group is None:
      return x
    out = x.detach().clone()
    dist.all_reduce(out, group=self.group)
    return out

  def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every process's ``x`` concatenated along ``dim``, in rank order."""
    if self.group is None:
      return x
    parts = [torch.empty_like(x) for _ in range(self.world)]
    dist.all_gather(parts, x.contiguous(), group=self.group)
    return torch.cat(parts, dim)

  def broadcast_(self, x: torch.Tensor) -> None:
    """Rank 0's ``x`` into every process's ``x``, in place."""
    if self.group is not None:
      dist.broadcast(x.data, src=0, group=self.group)

  def rows(self, n: int) -> slice:
    """This process's share of ``n`` rows (``n`` a multiple of world)."""
    k = n // self.world
    return slice(self.rank * k, (self.rank + 1) * k)


def data_mesh() -> DataMesh:
  """The default process group, or this process alone without one."""
  if not dist.is_initialized():
    return DataMesh(None, 1, 0)
  return DataMesh(dist.group.WORLD, dist.get_world_size(), dist.get_rank())


def shard_env_batch(mesh: DataMesh, tree):
  """This process's rows of every batched tensor in a tree of
  dataclasses, dicts and tensors (0-d tensors are kept whole)."""
  if isinstance(tree, torch.Tensor):
    return tree[mesh.rows(tree.shape[0])] if tree.ndim else tree
  if isinstance(tree, dict):
    return {k: shard_env_batch(mesh, v) for k, v in tree.items()}
  if dataclasses.is_dataclass(tree):
    return dataclasses.replace(tree, **{
        f.name: shard_env_batch(mesh, getattr(tree, f.name))
        for f in dataclasses.fields(tree)})
  return tree


def replicate(mesh: DataMesh, tree):
  """Rank 0's values in every tensor, module parameter and buffer and
  optimizer state of ``tree``, in place; returns ``tree``."""
  if isinstance(tree, torch.Tensor):
    mesh.broadcast_(tree)
  elif isinstance(tree, torch.nn.Module):
    for t in list(tree.parameters()) + list(tree.buffers()):
      mesh.broadcast_(t)
  elif isinstance(tree, torch.optim.Optimizer):
    for state in tree.state.values():
      for v in state.values():
        if isinstance(v, torch.Tensor) and v.ndim:
          mesh.broadcast_(v)
  elif isinstance(tree, (list, tuple)):
    for v in tree:
      replicate(mesh, v)
  elif dataclasses.is_dataclass(tree):
    for f in dataclasses.fields(tree):
      replicate(mesh, getattr(tree, f.name))
  return tree


class _ShardReductions(BatchReductions):
  """The learner's batch reductions across the mesh's processes, each of
  which holds an equal share of the batch. Each reduces its own share
  with the single-process calls first, so that one process computes
  exactly what the plain learner does."""
  mesh: DataMesh

  def batch_sum(self, x):
    return self.mesh.all_sum(x)

  def batch_mean(self, x):
    return self.mesh.all_sum(x) / self.mesh.world

  def _combine(self, mean, var):
    """The batch's (mean, variance) from this share's: with equal shares,
    the mean of the shares' means, and their mean variance plus the
    variance of their means."""
    whole = self.batch_mean(mean)
    return whole, self.batch_mean(var + torch.square(mean - whole))

  def moments(self, x):
    # the plain learner's calls on this share (see BatchReductions)
    mean, var = self._combine(x.mean(), x.var(correction=0))
    return mean, torch.sqrt(var)

  def norm_update(self, norm, batch):
    # the calls of RunningNorm.update on this share
    flat = norm.samples(batch)
    mean, var = self._combine(flat.mean(dim=0),
                              flat.var(dim=0, correction=0))
    return norm.merge(mean, var, flat.shape[0] * self.mesh.world)

  def sync_grads(self, params):
    grads = [p.grad for p in params]
    total = self.mesh.all_sum(torch.cat([g.reshape(-1) for g in grads]))
    total /= self.mesh.world
    for g, part in zip(grads, total.split([g.numel() for g in grads])):
      g.copy_(part.view_as(g))

  def gather_envs(self, x):
    return self.mesh.all_gather(x, 1)


class _ShardPPO(_ShardReductions, PPO):
  pass


class _ShardNPG(_ShardReductions, NPG):
  pass


class _Sharded:
  """What the two data-parallel learners share: ``local``, the learner
  of this process's envs whose reductions cross the mesh, and the
  whole-batch learner it was made from."""

  def __init__(self, learner, mesh: DataMesh | None, seed: int):
    self.learner = learner
    self.mesh = mesh or data_mesh()
    self.device = learner.device
    self.cfg = learner.cfg
    n = self.mesh.world
    if learner.cfg.num_envs % n:
      raise ValueError(f"num_envs={learner.cfg.num_envs} not divisible by "
                       f"the {n} processes of the mesh")
    # the env draws of this process's rollouts (see the module note)
    self.env_generator = (
        None if n == 1 else torch.Generator(device=self.device).manual_seed(
            seed + 1_000_003 * (self.mesh.rank + 1)))

  def _local(self, cls, learner, **cfg):
    local = cls(learner.env, dataclasses.replace(learner.cfg, **cfg),
                learner.device)
    local.mesh = self.mesh
    return local

  def init(self, seed: int = 0, generator: torch.Generator | None = None):
    """The single-process init (every process builds it alike), placed."""
    return self.place(self.learner.init(seed, generator))

  def train_step(self, ts, generator: torch.Generator):
    """One iteration; the global draws come from ``generator``."""
    return self.train_step_from(ts, **self.learner.draw(generator),
                                generator=generator)

  def train_step_from(self, ts, noise: torch.Tensor, perms: torch.Tensor,
                      generator: torch.Generator | None = None):
    """``noise`` [T, N, A] and ``perms`` are the whole batch's; each
    process takes its share of both (``local_perms``)."""
    new_ts, metrics = self.local.train_step_from(
        ts, noise[:, self.mesh.rows(noise.shape[1])], self.local_perms(perms),
        generator if self.env_generator is None else self.env_generator)
    per_iter = new_ts.steps - ts.steps          # this process's env steps
    return dataclasses.replace(
        new_ts, steps=ts.steps + per_iter * self.mesh.world), metrics

  def eval_step(self, ts, **kw):
    return self.learner.eval_step(ts, **kw)


class ShardedPPO(_Sharded):
  """Data-parallel PPO: each process steps num_envs / world envs, the
  actor-critic and its optimizer are replicated. ``data_groups`` must be
  a multiple of the world size, so that minibatch shuffles stay local."""

  def __init__(self, ppo: PPO, mesh: DataMesh | None = None, seed: int = 0):
    super().__init__(ppo, mesh, seed)
    n = self.mesh.world
    groups = min(ppo.cfg.data_groups, ppo.cfg.num_envs)
    if groups % n:
      raise ValueError(
          f"data_groups={groups} must be a multiple of the {n} processes "
          "of the mesh so that minibatch shuffles stay local")
    self.local = self._local(_ShardPPO, ppo, num_envs=ppo.cfg.num_envs // n,
                             data_groups=groups // n)

  def place(self, ts: TrainState) -> TrainState:
    """This process's envs of a whole-batch state; the rest replicated."""
    replicate(self.mesh, (ts.params, ts.opt_state, ts.steps, ts.obs_norm,
                          ts.ret_norm))
    return dataclasses.replace(
        ts, env_state=shard_env_batch(self.mesh, ts.env_state),
        ret_accum=shard_env_batch(self.mesh, ts.ret_accum))

  def local_perms(self, perms: torch.Tensor) -> torch.Tensor:
    """[epochs, groups, group size]: this process's groups."""
    return perms[:, self.mesh.rows(perms.shape[1])]


class ShardedNPG(_Sharded):
  """Data-parallel NPG: each process rolls out num_envs / world
  trajectories; the policy, the baseline and its optimizer are
  replicated, and the value fit runs on the gathered batch."""

  def __init__(self, npg: NPG, mesh: DataMesh | None = None, seed: int = 0):
    super().__init__(npg, mesh, seed)
    self.local = self._local(_ShardNPG, npg,
                             num_envs=npg.cfg.num_envs // self.mesh.world)

  def place(self, ts: NPGState) -> NPGState:
    replicate(self.mesh, (ts.params, ts.vf_params, ts.vf_opt, ts.steps,
                          ts.obs_norm))
    return ts

  def local_perms(self, perms: torch.Tensor) -> torch.Tensor:
    """[epochs, N*T] order the whole gathered batch: kept whole."""
    return perms
