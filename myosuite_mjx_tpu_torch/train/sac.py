"""SAC learner: off-policy soft actor-critic on a batch of environments.

Counterpart of ``myosuite_mjx_tpu/train/sac.py`` (SB3's defaults: twin Q
critics, tanh-squashed Gaussian actor, polyak target updates with tau
0.005, automatic entropy tuning to -act_dim, lr 3e-4, batch 256). The JAX
package runs one iteration as one jitted program; here it is three methods
on tensors, run eagerly on one device:

- ``collect``: one batched ``MyoEnv.autoreset_step`` with the actor's
  tanh-Gaussian action, or a uniform one before ``learning_starts``;
- ``insert``: the transitions into the replay buffer, a ring of tensors on
  the device;
- ``update``: ``updates_per_step`` gradient steps on uniform minibatches
  (critic, then actor against the updated critic, then temperature, then
  polyak). Before ``learning_starts`` they run on copies that are thrown
  away, as the reference computes them and keeps the old carry: nets,
  target and all three Adam states stay as they were, and the metrics are
  those of the discarded steps.

``train_step(state, generator)`` draws the action noise, the warmup actions,
the minibatch indices and the sampler's noise from a ``torch.Generator``;
``train_step_from`` takes them, so that a test can hand in the JAX
package's. The step count, the buffer cursor and the fill flag are host
integers (they do not depend on data), so nothing in ``train_step`` waits
for the card. The nets and optimizers in a ``SACState`` are updated in
place, as is the buffer; the returned state shares them.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch
from torch import nn

from myosuite_mjx_tpu_torch.envs import base as env_base
from myosuite_mjx_tpu_torch.envs.base import EnvState, MyoEnv
from myosuite_mjx_tpu_torch.train.common import (_adam_state, adam, dense,
                                                 load_adam_state,
                                                 load_flax_params,
                                                 metrics_to_host, mlp)

_LOG_STD_MIN, _LOG_STD_MAX = -20.0, 2.0
_LOG_2PI = math.log(2 * math.pi)
BUFFER_FIELDS = ("obs", "act", "rew", "next_obs", "done")


class Actor(nn.Module):
  """ReLU MLP with a mean head and a clipped log-std head. flax names the
  hidden layers ``Dense_0`` .. ``Dense_{L-1}``, the mean ``Dense_L`` and
  the log-std ``Dense_{L+1}``."""

  def __init__(self, obs_dim: int, act_dim: int, hidden: tuple = (256, 256),
               generator: torch.Generator | None = None,
               dtype: torch.dtype = torch.float32, device="cuda"):
    super().__init__()
    width = hidden[-1] if hidden else obs_dim
    self.hidden = mlp([obs_dim, *hidden], generator, dtype, device)
    self.mean_head = dense(width, act_dim, generator, dtype, device)
    self.log_std_head = dense(width, act_dim, generator, dtype, device)

  def flax_dense(self) -> list:
    layers = [*self.hidden, self.mean_head, self.log_std_head]
    return [(f"Dense_{i}", layer) for i, layer in enumerate(layers)]

  def forward(self, obs: torch.Tensor):
    x = obs
    for layer in self.hidden:
      x = torch.relu(layer(x))
    return (self.mean_head(x),
            self.log_std_head(x).clamp(_LOG_STD_MIN, _LOG_STD_MAX))


class TwinQ(nn.Module):
  """Two ReLU MLP critics of (obs, act). flax builds both in one compact
  scope: the first is ``Dense_0`` .. ``Dense_L``, the second
  ``Dense_{L+1}`` .. ``Dense_{2L+1}``."""

  def __init__(self, in_dim: int, hidden: tuple = (256, 256),
               generator: torch.Generator | None = None,
               dtype: torch.dtype = torch.float32, device="cuda"):
    super().__init__()
    self.q1 = mlp([in_dim, *hidden, 1], generator, dtype, device)
    self.q2 = mlp([in_dim, *hidden, 1], generator, dtype, device)

  def flax_dense(self) -> list:
    return [(f"Dense_{i}", layer)
            for i, layer in enumerate([*self.q1, *self.q2])]

  @staticmethod
  def _q(layers, x):
    for layer in layers[:-1]:
      x = torch.relu(layer(x))
    return layers[-1](x)[..., 0]

  def forward(self, obs: torch.Tensor, act: torch.Tensor):
    x = torch.cat([obs, act], dim=-1)
    return self._q(self.q1, x), self._q(self.q2, x)


def sample_tanh(mean, log_std, eps):
  """Tanh-squashed Gaussian sample from unit-normal ``eps`` and its
  log-prob (SAC appendix C; 1 - a^2 floored at 1e-6)."""
  act = torch.tanh(mean + torch.exp(log_std) * eps)
  logp = torch.sum(
      -0.5 * (eps ** 2 + 2 * log_std + _LOG_2PI)
      - torch.log(torch.clamp(1.0 - act ** 2, min=1e-6)), dim=-1)
  return act, logp


@dataclasses.dataclass(frozen=True)
class SACConfig:
  num_envs: int = 32
  buffer_size: int = 1 << 17
  batch_size: int = 256
  learning_rate: float = 3e-4
  gamma: float = 0.99
  tau: float = 0.005
  updates_per_step: int = 1      # gradient steps per collected env-step row
  learning_starts: int = 1000    # env steps before updates begin
  hidden: tuple = (256, 256)


@dataclasses.dataclass
class SACState:
  actor_params: Actor
  q_params: TwinQ
  q_target: TwinQ
  log_alpha: torch.Tensor        # () leaf, requires grad
  actor_opt: torch.optim.Adam
  q_opt: torch.optim.Adam
  alpha_opt: torch.optim.Adam
  buffer: dict                   # BUFFER_FIELDS -> [buffer_size, ...]
  buf_pos: int                   # insert cursor
  buf_full: bool
  env_state: EnvState            # batched [num_envs]
  steps: int                     # env steps collected


def sac_state_from_numpy(sac: "SAC", tree) -> SACState:
  """Carry a JAX ``SACState`` (leaves as numpy) into the port: flax kernels
  become ``nn.Linear`` weights, optax's Adam states torch Adam's, the env
  state goes through ``envs.base.state_from_numpy``; the JAX key has no
  counterpart (draws are given to ``train_step_from``)."""
  dt, dev = sac.dtype, sac.device
  obs_dim = int(np.asarray(
      tree.actor_params["params"]["Dense_0"]["kernel"]).shape[0])
  actor, q, q_target = sac.make_nets(obs_dim, torch.Generator(device=dev))
  for net, params in ((actor, tree.actor_params), (q, tree.q_params),
                      (q_target, tree.q_target)):
    load_flax_params(net, params)
  t = lambda x: torch.as_tensor(np.array(x), device=dev).to(dt)
  log_alpha = t(tree.log_alpha).requires_grad_()
  lr = sac.cfg.learning_rate
  actor_opt, q_opt = adam(actor, lr), adam(q, lr)
  load_adam_state(actor_opt, actor, tree.actor_opt)
  load_adam_state(q_opt, q, tree.q_opt)
  alpha_opt = adam([log_alpha], lr)
  st = _adam_state(tree.alpha_opt)
  alpha_opt.state[log_alpha] = {
      "step": torch.tensor(float(np.asarray(st.count)), dtype=torch.float32),
      "exp_avg": t(st.mu), "exp_avg_sq": t(st.nu)}
  return SACState(
      actor_params=actor, q_params=q, q_target=q_target, log_alpha=log_alpha,
      actor_opt=actor_opt, q_opt=q_opt, alpha_opt=alpha_opt,
      buffer={k: t(tree.buffer[k]) for k in BUFFER_FIELDS},
      buf_pos=int(np.asarray(tree.buf_pos)),
      buf_full=bool(np.asarray(tree.buf_full)),
      env_state=env_base.state_from_numpy(tree.env_state, dev),
      steps=int(np.asarray(tree.steps)))


class SAC:
  """SAC trainer bound to a MyoEnv, on one device (the card unless the
  caller asks for the CPU)."""

  def __init__(self, env: MyoEnv, config: SACConfig = SACConfig(),
               device="cuda"):
    self.env = env
    self.cfg = config
    self.device = torch.device(device)
    self.dtype = env.dtype
    self.act_dim = int(env.action_dim)
    self.target_entropy = -float(self.act_dim)

  def make_nets(self, obs_dim: int, generator):
    """(actor, critic, target critic); the target starts as the critic."""
    cfg, dt, dev = self.cfg, self.dtype, self.device
    actor = Actor(obs_dim, self.act_dim, cfg.hidden, generator, dt, dev)
    q = TwinQ(obs_dim + self.act_dim, cfg.hidden, generator, dt, dev)
    return actor, q, copy.deepcopy(q).requires_grad_(False)

  def init(self, seed: int = 0,
           generator: torch.Generator | None = None) -> SACState:
    cfg = self.cfg
    g = (generator if generator is not None
         else torch.Generator(device=self.device).manual_seed(seed))
    env_state = self.env.reset(cfg.num_envs, self.device, g)
    obs_dim = int(env_state.obs.shape[-1])
    actor, q, q_target = self.make_nets(obs_dim, g)
    log_alpha = torch.zeros((), dtype=self.dtype, device=self.device,
                            requires_grad=True)
    z = lambda *shape: torch.zeros((cfg.buffer_size, *shape),
                                   dtype=self.dtype, device=self.device)
    lr = cfg.learning_rate
    return SACState(
        actor_params=actor, q_params=q, q_target=q_target,
        log_alpha=log_alpha, actor_opt=adam(actor, lr), q_opt=adam(q, lr),
        alpha_opt=adam([log_alpha], lr),
        buffer=dict(obs=z(obs_dim), act=z(self.act_dim), rew=z(),
                    next_obs=z(obs_dim), done=z()),
        buf_pos=0, buf_full=False, env_state=env_state, steps=0)

  def cursor(self, ts: SACState) -> tuple[int, bool, int]:
    """(buf_pos, buf_full, size) after this iteration's insert."""
    cfg = self.cfg
    pos = (ts.buf_pos + cfg.num_envs) % cfg.buffer_size
    full = ts.buf_full or ts.buf_pos + cfg.num_envs >= cfg.buffer_size
    return pos, full, cfg.buffer_size if full else pos

  def draw(self, ts: SACState, generator: torch.Generator) -> dict:
    """One iteration's draws: the action noise and the warmup actions
    [N, A], minibatch indices [U, batch] in [0, max(size, 1)) and the
    sampler's noise for the critic target and the actor loss
    [U, batch, A]."""
    cfg = self.cfg
    kw = dict(generator=generator, dtype=self.dtype, device=self.device)
    N, A, U, M = (cfg.num_envs, self.act_dim, cfg.updates_per_step,
                  cfg.batch_size)
    size = self.cursor(ts)[2]
    return dict(
        eps_act=torch.randn((N, A), **kw),
        uniform_act=torch.rand((N, A), **kw) * 2.0 - 1.0,
        mb_idx=torch.randint(0, max(size, 1), (U, M), generator=generator,
                             device=self.device),
        eps_next=torch.randn((U, M, A), **kw),
        eps_pi=torch.randn((U, M, A), **kw))

  # ---- the parts of one iteration ----------------------------------------

  @torch.no_grad()
  def collect(self, ts: SACState, eps_act: torch.Tensor,
              uniform_act: torch.Tensor,
              generator: torch.Generator | None = None):
    """One autoreset step of every env; returns (action, next state)."""
    if ts.steps < self.cfg.learning_starts:
      act = uniform_act                 # SB3's warmup: uniform actions
    else:
      act, _ = sample_tanh(*ts.actor_params(ts.env_state.obs), eps_act)
    return act, self.env.autoreset_step(ts.env_state, act, generator)

  @torch.no_grad()
  def insert(self, ts: SACState, act: torch.Tensor, nxt: EnvState) -> None:
    """Write the transitions at the cursor (wrapping). ``done`` is
    termination only, so the update bootstraps through timeouts."""
    cfg = self.cfg
    idx = (torch.arange(cfg.num_envs, device=self.device)
           + ts.buf_pos) % cfg.buffer_size
    rows = dict(obs=ts.env_state.obs, act=act, rew=nxt.info["rwd_dense"],
                next_obs=nxt.obs, done=nxt.done.to(self.dtype))
    for k, v in rows.items():
      ts.buffer[k].index_copy_(0, idx, v.to(self.dtype))

  def update(self, ts: SACState, mb_idx: torch.Tensor,
             eps_next: torch.Tensor, eps_pi: torch.Tensor) -> dict:
    """``updates_per_step`` gradient steps on the minibatches ``mb_idx``;
    on throwaway copies before ``learning_starts``. Returns the mean critic
    and actor losses and alpha after the last step."""
    cfg = self.cfg
    nets = (ts.actor_params, ts.q_params, ts.q_target, ts.log_alpha,
            ts.actor_opt, ts.q_opt, ts.alpha_opt)
    if ts.steps < cfg.learning_starts:
      nets = copy.deepcopy(nets)   # one deepcopy keeps each Adam on its net
    actor, q, q_target, log_alpha, actor_opt, q_opt, alpha_opt = nets
    actor_params = list(actor.parameters())
    target_params = list(q_target.parameters())
    q_params = list(q.parameters())
    q_losses, a_losses = [], []
    for u in range(cfg.updates_per_step):
      mb = {k: v[mb_idx[u]] for k, v in ts.buffer.items()}
      alpha = log_alpha.detach().exp()      # before this step's update

      with torch.no_grad():
        next_act, next_logp = sample_tanh(*actor(mb["next_obs"]),
                                          eps_next[u])
        tq1, tq2 = q_target(mb["next_obs"], next_act)
        target = mb["rew"] + cfg.gamma * (1 - mb["done"]) * (
            torch.minimum(tq1, tq2) - alpha * next_logp)
      q1, q2 = q(mb["obs"], mb["act"])
      q_loss = 0.5 * ((q1 - target).square().mean()
                      + (q2 - target).square().mean())
      q_opt.zero_grad()
      q_loss.backward()
      q_opt.step()

      # the actor against the critic after its step
      act, logp = sample_tanh(*actor(mb["obs"]), eps_pi[u])
      q1, q2 = q(mb["obs"], act)
      a_loss = (alpha * logp - torch.minimum(q1, q2)).mean()
      actor_opt.zero_grad()
      a_loss.backward(inputs=actor_params)
      actor_opt.step()

      al_loss = -(log_alpha.exp()
                  * (logp.detach() + self.target_entropy)).mean()
      alpha_opt.zero_grad()
      al_loss.backward()
      alpha_opt.step()

      with torch.no_grad():
        torch._foreach_mul_(target_params, 1.0 - cfg.tau)
        torch._foreach_add_(target_params, q_params, alpha=cfg.tau)
      q_losses.append(q_loss.detach())
      a_losses.append(a_loss.detach())
    return dict(q_loss=torch.stack(q_losses).mean(),
                a_loss=torch.stack(a_losses).mean(),
                alpha=log_alpha.detach().exp())

  # ---- one training iteration ---------------------------------------------

  def train_step(self, ts: SACState, generator: torch.Generator):
    return self.train_step_from(ts, self.draw(ts, generator), generator)

  def train_step_from(self, ts: SACState, draws: dict,
                      generator: torch.Generator | None = None):
    """Collect ``num_envs`` transitions, insert them, then update; returns
    (new state, metrics as device scalars)."""
    act, nxt = self.collect(ts, draws["eps_act"], draws["uniform_act"],
                            generator)
    self.insert(ts, act, nxt)
    pos, full, size = self.cursor(ts)
    metrics = self.update(ts, draws["mb_idx"], draws["eps_next"],
                          draws["eps_pi"])
    new_ts = dataclasses.replace(ts, buf_pos=pos, buf_full=full,
                                 env_state=nxt,
                                 steps=ts.steps + self.cfg.num_envs)
    return new_ts, dict(
        reward_mean=nxt.info["rwd_dense"].mean(), **metrics,
        buffer_size=torch.full((), size, dtype=self.dtype,
                               device=self.device))

  # ---- training loop -------------------------------------------------------

  def train(self, total_env_steps: int, seed: int = 0,
            progress: Callable | None = None, writer=None,
            check_every: int = 50):
    """Run training; returns (SACState, the metric dicts given to
    ``progress``).

    One generator, seeded with ``seed``, makes the init and every
    iteration's draws. An iteration is one env step of every env, so the
    metrics come to the host, and non-finite ones raise
    ``metrics.DivergenceError``, only every ``check_every`` iterations, at
    the last, and at each one a ``progress`` or ``writer`` reads.
    """
    from myosuite_mjx_tpu_torch.train import metrics as metrics_mod
    N = self.cfg.num_envs
    generator = torch.Generator(device=self.device).manual_seed(seed)
    ts = self.init(generator=generator)
    iters = max(1, total_env_steps // N)
    history = []
    t0 = time.time()
    for it in range(iters):
      ts, metrics = self.train_step(ts, generator)
      if (progress is not None or writer is not None
          or (it + 1) % check_every == 0 or it == iters - 1):
        metrics = metrics_to_host(metrics)
        metrics_mod.check_finite(metrics, where=f"SAC iter {it}")
        metrics["wall"] = time.time() - t0
        metrics["env_steps"] = (it + 1) * N
        if writer is not None:
          writer.write(metrics["env_steps"], metrics)
        if progress is not None:
          history.append(metrics)
          progress(it, metrics)
    return ts, history
