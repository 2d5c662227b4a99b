"""PPO learner: batched rollout + clipped-surrogate updates.

Counterpart of ``myosuite_mjx_tpu/train/ppo.py``, which keeps rollout, GAE
and the minibatch epochs in one jitted ``train_step``. Here they are
methods on tensors, run eagerly on one device:

- ``rollout``: ``unroll_length`` steps of the batched
  ``MyoEnv.autoreset_step``, action noise given as one tensor [T, N, A];
- ``normalize``: running obs and return statistics, reward scaling;
- ``gae``: a reverse loop over T;
- ``update``: epochs of minibatches over group-local permutations (given as
  one tensor [epochs, groups, group size]), each a global-norm clip and an
  Adam step.

``train_step(state, generator)`` draws the noise and the permutations from a
``torch.Generator`` and runs them; ``train_step_from`` takes the draws, so
that a test can hand in the JAX package's. The nets and the optimizer in a
``TrainState`` are updated in place; the returned state shares them.

This module also holds what the NPG learner shares with it
(``RunningNorm``, ``gaussian_logp``) and the carry of a JAX ``TrainState``
(leaves as numpy) into the port; what every learner shares is in
``train/common.py``.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Callable

import numpy as np
import torch
from torch import nn

from myosuite_mjx_tpu_torch.envs import base as env_base
from myosuite_mjx_tpu_torch.envs.base import EnvState, MyoEnv
# _flax_leaves, dense and flax_params also stay importable from here
from myosuite_mjx_tpu_torch.train.common import (  # noqa: F401
    BatchReductions, _flax_leaves, adam, dense, flax_params, load_adam_state,
    load_flax_params, metrics_to_host, mlp)

_LOG_2PI = math.log(2 * math.pi)


class ActorCritic(nn.Module):
  """Tanh-MLP actor-critic with state-independent log-std.

  flax names the layers in creation order: the policy's ``Dense_0`` to
  ``Dense_L`` (L = len(hidden)), then the value's ``Dense_{L+1}`` to
  ``Dense_{2L+1}``; ``flax_dense`` gives that mapping.
  """

  def __init__(self, obs_dim: int, act_dim: int, hidden: tuple = (256, 128),
               init_log_std: float = -0.5, min_log_std: float = -math.inf,
               generator: torch.Generator | None = None,
               dtype: torch.dtype = torch.float32, device="cuda"):
    super().__init__()
    sizes = [obs_dim, *hidden]
    self.pi = mlp(sizes + [act_dim], generator, dtype, device)
    self.v = mlp(sizes + [1], generator, dtype, device)
    self.log_std = nn.Parameter(torch.full((act_dim,), init_log_std,
                                           dtype=dtype, device=device))
    self.min_log_std = min_log_std

  def flax_dense(self) -> list:
    return [(f"Dense_{i}", layer)
            for i, layer in enumerate(list(self.pi) + list(self.v))]

  def forward(self, obs: torch.Tensor):
    x = obs
    for layer in self.pi[:-1]:
      x = torch.tanh(layer(x))
    mean = self.pi[-1](x)
    v = obs
    for layer in self.v[:-1]:
      v = torch.tanh(layer(v))
    value = self.v[-1](v)[..., 0]
    return mean, self.log_std.clamp_min(self.min_log_std), value


@dataclasses.dataclass(frozen=True)
class PPOConfig:
  num_envs: int = 128
  unroll_length: int = 50
  num_minibatches: int = 32
  update_epochs: int = 8
  learning_rate: float = 3e-4
  gamma: float = 0.99
  gae_lambda: float = 0.95
  clip_eps: float = 0.2
  vf_coef: float = 0.5
  ent_coef: float = 0.0
  max_grad_norm: float = 0.5
  hidden: tuple = (256, 128)
  # shuffling and minibatching are local to each of data_groups groups of
  # envs, as in the reference (there so that a sharded batch gathers
  # on-shard); kept for parity of the draws and the minibatches
  data_groups: int = 8
  init_log_std: float = -0.5
  min_log_std: float = -math.inf
  normalize_obs: bool = True
  normalize_reward: bool = True
  norm_clip: float = 10.0


@dataclasses.dataclass(frozen=True)
class RunningNorm:
  """Welford-merged running mean/var (VecNormalize semantics)."""
  mean: torch.Tensor
  var: torch.Tensor
  count: torch.Tensor

  @classmethod
  def create(cls, dim: int | tuple = (), dtype: torch.dtype = torch.float32,
             device="cuda") -> "RunningNorm":
    shape = (dim,) if isinstance(dim, int) else tuple(dim)
    return cls(mean=torch.zeros(shape, dtype=dtype, device=device),
               var=torch.ones(shape, dtype=dtype, device=device),
               count=torch.full((), 1e-4, dtype=dtype, device=device))

  def samples(self, batch: torch.Tensor) -> torch.Tensor:
    """The batch as [samples, *shape]."""
    return batch.reshape((-1,) + tuple(self.mean.shape))

  def update(self, batch: torch.Tensor) -> "RunningNorm":
    flat = self.samples(batch)
    # jnp.var: ddof 0
    return self.merge(flat.mean(dim=0), flat.var(dim=0, correction=0),
                      flat.shape[0])

  def merge(self, bmean: torch.Tensor, bvar: torch.Tensor,
            bcount: int) -> "RunningNorm":
    """Welford's merge of a batch's mean, variance and count."""
    delta = bmean - self.mean
    tot = self.count + bcount
    new_mean = self.mean + delta * bcount / tot
    m2 = (self.var * self.count + bvar * bcount
          + delta * delta * self.count * bcount / tot)
    return RunningNorm(mean=new_mean, var=m2 / tot, count=tot)

  def apply(self, x: torch.Tensor, clip: float = 10.0) -> torch.Tensor:
    return ((x - self.mean) / torch.sqrt(self.var + 1e-8)).clamp(-clip, clip)


@dataclasses.dataclass
class TrainState:
  params: ActorCritic
  opt_state: torch.optim.Adam
  env_state: EnvState          # batched [num_envs]
  steps: torch.Tensor          # total env steps, int64
  obs_norm: RunningNorm
  ret_norm: RunningNorm        # running var of discounted returns
  ret_accum: torch.Tensor      # [num_envs] running discounted return


def gaussian_logp(mean, log_std, action):
  var = torch.exp(2 * log_std)
  return torch.sum(
      -0.5 * ((action - mean) ** 2 / var + 2 * log_std + _LOG_2PI), dim=-1)


def clip_by_global_norm(params, max_norm: float) -> None:
  """optax.clip_by_global_norm on ``.grad``: g * max_norm / |g| where
  |g| >= max_norm, with no epsilon (clip_grad_norm_ adds 1e-6) and no host
  sync."""
  grads = [p.grad for p in params]
  g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
  keep = g_norm < max_norm
  for g in grads:
    g.copy_(torch.where(keep, g, g / g_norm * max_norm))


# ---- carrying JAX state (leaves as numpy) into the port ------------------

def norm_from_numpy(tree, dtype: torch.dtype, device) -> RunningNorm:
  t = lambda x: torch.as_tensor(np.array(x), device=device).to(dtype)
  return RunningNorm(mean=t(tree.mean), var=t(tree.var), count=t(tree.count))


def train_state_from_numpy(ppo: "PPO", tree) -> TrainState:
  """Carry a JAX PPO ``TrainState`` (leaves as numpy) into the port: flax
  kernels become ``nn.Linear`` weights, optax's Adam state torch Adam's, the
  env state goes through ``envs.base.state_from_numpy``; the JAX key has no
  counterpart (draws are given to ``train_step``)."""
  p = tree.params["params"]
  net = ppo.make_net(int(np.asarray(p["Dense_0"]["kernel"]).shape[0]),
                     torch.Generator(device=ppo.device))
  load_flax_params(net, tree.params)
  opt = adam(net, ppo.cfg.learning_rate)
  load_adam_state(opt, net, tree.opt_state)
  dt, dev = ppo.dtype, ppo.device
  return TrainState(
      params=net, opt_state=opt,
      env_state=env_base.state_from_numpy(tree.env_state, dev),
      steps=torch.as_tensor(int(np.asarray(tree.steps)), dtype=torch.int64,
                            device=dev),
      obs_norm=norm_from_numpy(tree.obs_norm, dt, dev),
      ret_norm=norm_from_numpy(tree.ret_norm, dt, dev),
      ret_accum=torch.as_tensor(np.array(tree.ret_accum),
                                device=dev).to(dt))


# ---- the learner ---------------------------------------------------------

class PPO(BatchReductions):
  """PPO trainer bound to a MyoEnv, on one device (the card unless the
  caller asks for the CPU)."""

  def __init__(self, env: MyoEnv, config: PPOConfig = PPOConfig(),
               device="cuda"):
    self.env = env
    self.cfg = config
    self.device = torch.device(device)
    self.dtype = env.dtype
    self.act_dim = int(env.action_dim)

  def make_net(self, obs_dim: int, generator) -> ActorCritic:
    cfg = self.cfg
    return ActorCritic(obs_dim, self.act_dim, cfg.hidden, cfg.init_log_std,
                       cfg.min_log_std, generator, self.dtype, self.device)

  # ---- initialization ----------------------------------------------------

  def init(self, seed: int = 0,
           generator: torch.Generator | None = None) -> TrainState:
    g = (generator if generator is not None
         else torch.Generator(device=self.device).manual_seed(seed))
    env_state = self.env.reset(self.cfg.num_envs, self.device, g)
    obs_dim = int(env_state.obs.shape[-1])
    net = self.make_net(obs_dim, g)
    dt, dev = self.dtype, self.device
    return TrainState(
        params=net, opt_state=adam(net, self.cfg.learning_rate),
        env_state=env_state,
        steps=torch.zeros((), dtype=torch.int64, device=dev),
        obs_norm=RunningNorm.create(obs_dim, dt, dev),
        ret_norm=RunningNorm.create((), dt, dev),
        ret_accum=torch.zeros(self.cfg.num_envs, dtype=dt, device=dev))

  # ---- batch layout --------------------------------------------------------

  def layout(self) -> tuple[int, int, int]:
    """(groups G, samples per group ng, minibatch count): the count is the
    largest divisor of ng that divides the requested one."""
    cfg = self.cfg
    G = min(cfg.data_groups, cfg.num_envs)
    if cfg.num_envs % G:
      raise ValueError(f"num_envs={cfg.num_envs} not divisible by "
                       f"data_groups={G}")
    ng = (cfg.num_envs // G) * cfg.unroll_length
    return G, ng, math.gcd(ng, cfg.num_minibatches)

  def draw(self, generator: torch.Generator) -> dict:
    """Action noise [T, N, A] and per-epoch, per-group permutations
    [epochs, G, ng]."""
    cfg = self.cfg
    G, ng, _ = self.layout()
    noise = torch.randn((cfg.unroll_length, cfg.num_envs, self.act_dim),
                        generator=generator, dtype=self.dtype,
                        device=self.device)
    # argsort of float64 uniforms: a uniform permutation (ties ~2^-53)
    perms = torch.rand((cfg.update_epochs, G, ng), generator=generator,
                       dtype=torch.float64, device=self.device).argsort(dim=-1)
    return dict(noise=noise, perms=perms)

  # ---- the parts of one iteration ----------------------------------------

  @torch.no_grad()
  def rollout(self, ts: TrainState, noise: torch.Tensor,
              generator: torch.Generator | None = None):
    """T autoreset steps from ``ts.env_state``; returns the last env state,
    the carried discounted return and the trajectory, each field [T, N]."""
    cfg = self.cfg
    env_state, ret_accum = ts.env_state, ts.ret_accum
    traj: dict[str, list] = {k: [] for k in (
        "obs", "obs_raw", "act", "logp", "value", "reward", "ret_accum",
        "done", "solved")}
    for t in range(cfg.unroll_length):
      obs_raw = env_state.obs
      obs = (ts.obs_norm.apply(obs_raw, cfg.norm_clip)
             if cfg.normalize_obs else obs_raw)
      mean, log_std, value = ts.params(obs)
      act = mean + torch.exp(log_std) * noise[t]
      logp = gaussian_logp(mean, log_std, act)
      nxt = self.env.autoreset_step(env_state, act.clamp(-1.0, 1.0),
                                    generator)
      reward = nxt.info["rwd_dense"]
      done = (nxt.info["terminated"] | nxt.info["truncated"]).to(self.dtype)
      # accumulate first so the terminal discounted return enters the
      # variance estimate (SB3's order), zero at done for the carry
      ret_accum = ret_accum * cfg.gamma + reward
      for k, v in (("obs", obs), ("obs_raw", obs_raw), ("act", act),
                   ("logp", logp), ("value", value), ("reward", reward),
                   ("ret_accum", ret_accum), ("done", done),
                   ("solved", nxt.info["solved"].to(self.dtype))):
        traj[k].append(v)
      env_state = nxt
      ret_accum = ret_accum * (1.0 - done)
    return env_state, ret_accum, {k: torch.stack(v) for k, v in traj.items()}

  @torch.no_grad()
  def normalize(self, ts: TrainState, traj: dict):
    """New obs and return statistics (used from the next rollout on) and the
    rollout's reward scaled by the old return statistics."""
    cfg = self.cfg
    obs_norm = (self.norm_update(ts.obs_norm, traj["obs_raw"])
                if cfg.normalize_obs else ts.obs_norm)
    ret_norm = (self.norm_update(ts.ret_norm, traj["ret_accum"])
                if cfg.normalize_reward else ts.ret_norm)
    reward = traj["reward"]
    if cfg.normalize_reward:
      reward = (reward / torch.sqrt(ts.ret_norm.var + 1e-8)).clamp(
          -cfg.norm_clip, cfg.norm_clip)
    return obs_norm, ret_norm, reward

  @torch.no_grad()
  def gae(self, ts: TrainState, env_state: EnvState, traj: dict,
          reward: torch.Tensor):
    """Advantages and returns [T, N], bootstrapped from the last state."""
    cfg = self.cfg
    last_obs = (ts.obs_norm.apply(env_state.obs, cfg.norm_clip)
                if cfg.normalize_obs else env_state.obs)
    _, _, next_value = ts.params(last_obs)
    value, done = traj["value"], traj["done"]
    gae = torch.zeros_like(next_value)
    advs = torch.empty_like(value)
    for t in range(cfg.unroll_length - 1, -1, -1):
      delta = (reward[t] + cfg.gamma * next_value * (1 - done[t])
               - value[t])
      gae = delta + cfg.gamma * cfg.gae_lambda * (1 - done[t]) * gae
      advs[t] = gae
      next_value = value[t]
    return advs, advs + value

  def loss(self, net: ActorCritic, mb: dict):
    cfg = self.cfg
    mean, log_std, value = net(mb["obs"])
    logp = gaussian_logp(mean, log_std, mb["act"])
    ratio = torch.exp(logp - mb["logp"])
    adv_mean, adv_std = self.moments(mb["adv"])
    adv = (mb["adv"] - adv_mean) / (adv_std + 1e-8)
    pg1 = ratio * adv
    pg2 = ratio.clamp(1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    pg_loss = -torch.minimum(pg1, pg2).mean()
    v_loss = 0.5 * torch.square(value - mb["ret"]).mean()
    ent = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
    return pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent

  def update(self, ts: TrainState, batch: dict, perms: torch.Tensor,
             num_minibatches: int) -> torch.Tensor:
    """Minibatch epochs over ``batch`` (fields [G, ng, ...]); each epoch
    shuffles within each group by ``perms[epoch]``. Returns the mean loss."""
    G, ng = perms.shape[1:]
    mb_size = ng // num_minibatches
    net, opt = ts.params, ts.opt_state
    params = list(net.parameters())
    rows = torch.arange(G, device=self.device)[:, None]
    epoch_losses = []
    for epoch_perm in perms:
      shuf = {k: v[rows, epoch_perm] for k, v in batch.items()}
      losses = []
      for i in range(num_minibatches):
        mb = {k: v[:, i * mb_size:(i + 1) * mb_size] for k, v in shuf.items()}
        loss = self.loss(net, mb)
        opt.zero_grad()
        loss.backward()
        self.sync_grads(params)
        with torch.no_grad():
          clip_by_global_norm(params, self.cfg.max_grad_norm)
        opt.step()
        losses.append(loss.detach())
      epoch_losses.append(torch.stack(losses).mean())
    return torch.stack(epoch_losses).mean()

  # ---- one training iteration ---------------------------------------------

  def train_step(self, ts: TrainState, generator: torch.Generator):
    return self.train_step_from(ts, **self.draw(generator),
                                generator=generator)

  def train_step_from(self, ts: TrainState, noise: torch.Tensor,
                      perms: torch.Tensor,
                      generator: torch.Generator | None = None):
    cfg = self.cfg
    G, ng, num_minibatches = self.layout()
    if num_minibatches != cfg.num_minibatches:
      # changes the minibatch size, and so the optimization dynamics
      warnings.warn(
          f"num_minibatches adjusted {cfg.num_minibatches} -> "
          f"{num_minibatches}: group size {ng} (num_envs/data_groups * "
          f"unroll) is not divisible by the requested count", stacklevel=2)
    env_state, ret_accum, traj = self.rollout(ts, noise, generator)
    obs_norm, ret_norm, reward = self.normalize(ts, traj)
    advs, returns = self.gae(ts, env_state, traj, reward)

    def flat(x):                       # [T, N, ...] -> [G, ng, ...]
      x = x.movedim(0, 1)
      return x.reshape((G, ng) + tuple(x.shape[2:]))

    batch = dict(obs=flat(traj["obs"]), act=flat(traj["act"]),
                 logp=flat(traj["logp"]), adv=flat(advs), ret=flat(returns))
    loss = self.update(ts, batch, perms, num_minibatches)
    metrics = dict(loss=self.batch_mean(loss),
                   reward_mean=self.batch_mean(reward.mean()),
                   solved_frac=self.batch_mean(traj["solved"].mean()))
    new_ts = TrainState(
        params=ts.params, opt_state=ts.opt_state, env_state=env_state,
        steps=ts.steps + cfg.unroll_length * cfg.num_envs,
        obs_norm=obs_norm, ret_norm=ret_norm, ret_accum=ret_accum)
    return new_ts, metrics

  # ---- evaluation ----------------------------------------------------------

  @torch.no_grad()
  def eval_step(self, ts: TrainState, num_episodes_steps: int = 100,
                num_envs: int = 32,
                generator: torch.Generator | None = None) -> dict:
    """Deterministic-policy evaluation on fresh envs with autoreset: the
    reference's evaluate_success contract, an episode succeeds when solved
    on more than 5 steps."""
    cfg = self.cfg
    st = self.env.reset(num_envs, self.device, generator)
    zeros = torch.zeros(num_envs, dtype=self.dtype, device=self.device)
    cnt, succ, eps = zeros, zeros, zeros
    rewards, solveds, dones = [], [], []
    for _ in range(num_episodes_steps):
      obs = (ts.obs_norm.apply(st.obs, cfg.norm_clip)
             if cfg.normalize_obs else st.obs)
      mean, _, _ = ts.params(obs)
      st = self.env.autoreset_step(st, mean.clamp(-1.0, 1.0), generator)
      solved = st.info["solved"].to(self.dtype)
      done = (st.info["terminated"] | st.info["truncated"]).to(self.dtype)
      cnt = cnt + solved
      succ = succ + done * (cnt > 5.0).to(self.dtype)
      eps = eps + done
      cnt = cnt * (1.0 - done)
      rewards.append(st.info["rwd_dense"])
      solveds.append(solved)
      dones.append(done)
    return dict(
        eval_solved_frac=torch.stack(solveds).mean(),
        eval_success=succ.sum() / eps.sum().clamp_min(1.0),
        eval_reward_mean=torch.stack(rewards).mean(),
        eval_episodes=torch.stack(dones).sum().clamp_min(1.0))

  # ---- training loop ---------------------------------------------------------

  def train(self, total_env_steps: int, seed: int = 0,
            progress: Callable | None = None, eval_every: int = 0,
            writer=None):
    """Run training; returns (TrainState, list of metric dicts).

    One generator, seeded with ``seed``, makes the init and every
    iteration's draws; evaluation has a stream of its own. Metrics come to
    the host once per iteration; non-finite ones raise
    ``metrics.DivergenceError``.
    """
    from myosuite_mjx_tpu_torch.train import metrics as metrics_mod
    cfg = self.cfg
    generator = torch.Generator(device=self.device).manual_seed(seed)
    eval_gen = torch.Generator(device=self.device).manual_seed(
        seed ^ 0x45564C)
    ts = self.init(generator=generator)
    per_iter = cfg.unroll_length * cfg.num_envs
    iters = max(1, total_env_steps // per_iter)
    history = []
    t0 = time.time()
    for it in range(iters):
      ts, metrics = self.train_step(ts, generator)
      if eval_every and ((it + 1) % eval_every == 0 or it == iters - 1):
        metrics = {**metrics, **self.eval_step(
            ts, num_episodes_steps=min(self.env.horizon * 2, 200),
            generator=eval_gen)}
      metrics = metrics_to_host(metrics)
      metrics_mod.check_finite(metrics, where=f"PPO iter {it}")
      metrics["wall"] = time.time() - t0
      metrics["env_steps"] = (it + 1) * per_iter
      metrics["steps_per_s"] = round((it + 1) * per_iter
                                     / max(metrics["wall"], 1e-9), 1)
      history.append(metrics)
      if writer is not None:
        writer.write(metrics["env_steps"], metrics)
      if progress is not None:
        progress(it, metrics)
    return ts, history
