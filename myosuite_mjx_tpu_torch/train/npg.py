"""Natural Policy Gradient learner: the algorithm the zoo's hand-pose policy
was trained with.

Counterpart of ``myosuite_mjx_tpu/train/npg.py`` (mjrl's NPG: policy
(32, 32), init/min log-std -0.25/-1.0, gamma 0.995, GAE 0.97, normalized
KL step 0.1). The JAX package runs one iteration as one jitted program;
here it is four methods on tensors, which a caller can also run one at a
time:

- ``rollout``: N fresh episodes of T steps of the batched ``MyoEnv.step``
  (no autoreset) with a ``live`` mask, action noise given as [T, N, A];
- ``gae``: a reverse loop over T with the time-featured baseline, no
  bootstrap past the horizon;
- ``natural_gradient``: the surrogate gradient g, ``cg_iters`` conjugate-
  gradient steps on (F + damping I) x = g with Fisher-vector products as
  double-backward Hessian-vector products of the sampled mean KL at the
  old parameters, and the step theta + sqrt(2 delta / g.x) x. Every scalar
  stays on the device: no host sync inside;
- ``fit_value``: Adam epochs over minibatches of given permutations
  [epochs, N*T].

``train_step(state, generator)`` draws the noise and permutations from a
``torch.Generator``; ``train_step_from`` takes them, so that a test can
hand in the JAX package's draws. The nets and the optimizer in an
``NPGState`` are updated in place; the returned state shares them.

Two findings against the reference are matched, not fixed, so parity
stays testable: the advantage statistics include dead steps (reference
``npg.py:202``) and the eval keeps counting after ``done`` (``:330``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch
from torch import nn

from myosuite_mjx_tpu_torch.envs.base import MyoEnv
from myosuite_mjx_tpu_torch.train.common import (BatchReductions, adam,
                                                 load_adam_state,
                                                 load_flax_params,
                                                 metrics_to_host, mlp)
from myosuite_mjx_tpu_torch.train.ppo import (RunningNorm, gaussian_logp,
                                              norm_from_numpy)


class GaussianMLP(nn.Module):
  """mjrl-style policy: tanh MLP mean + per-dim learnable log_std with a
  floor (``min_log_std``)."""

  def __init__(self, obs_dim: int, act_dim: int, hidden: tuple = (32, 32),
               init_log_std: float = -0.25, min_log_std: float = -1.0,
               generator: torch.Generator | None = None,
               dtype: torch.dtype = torch.float32, device="cuda"):
    super().__init__()
    self.layers = mlp([obs_dim, *hidden, act_dim], generator, dtype, device)
    self.log_std = nn.Parameter(torch.full((act_dim,), init_log_std,
                                           dtype=dtype, device=device))
    self.min_log_std = min_log_std

  def flax_dense(self) -> list:
    return [(f"Dense_{i}", layer) for i, layer in enumerate(self.layers)]

  def forward(self, obs: torch.Tensor):
    x = obs
    for layer in self.layers[:-1]:
      x = torch.tanh(layer(x))
    return self.layers[-1](x), self.log_std.clamp_min(self.min_log_std)


class ValueMLP(nn.Module):
  """Baseline with mjrl MLPBaseline's time features: [t, t^2, t^3] of the
  normalized time appended to the obs, so that with Monte-Carlo returns and
  no horizon bootstrap it can represent the remaining-time value ramp."""

  def __init__(self, obs_dim: int, hidden: tuple = (128, 128),
               generator: torch.Generator | None = None,
               dtype: torch.dtype = torch.float32, device="cuda"):
    super().__init__()
    self.layers = mlp([obs_dim + 3, *hidden, 1], generator, dtype, device)

  def flax_dense(self) -> list:
    return [(f"Dense_{i}", layer) for i, layer in enumerate(self.layers)]

  def forward(self, obs: torch.Tensor, tfrac: torch.Tensor) -> torch.Tensor:
    t = torch.stack([tfrac, tfrac ** 2, tfrac ** 3], dim=-1)
    x = torch.cat([obs, t], dim=-1)
    for layer in self.layers[:-1]:
      x = torch.relu(layer(x))
    return self.layers[-1](x)[..., 0]


@dataclasses.dataclass(frozen=True)
class NPGConfig:
  num_envs: int = 96            # trajectories per iteration (rl_num_traj)
  step_size: float = 0.1        # normalized KL step (rl_step_size)
  gamma: float = 0.995
  gae_lambda: float = 0.97
  cg_iters: int = 10
  cg_damping: float = 1e-4
  hidden: tuple = (32, 32)
  init_log_std: float = -0.25
  min_log_std: float = -1.0
  vf_hidden: tuple = (128, 128)
  vf_epochs: int = 2
  vf_batch_size: int = 64
  vf_learning_rate: float = 1e-3
  normalize_obs: bool = True
  norm_clip: float = 10.0


@dataclasses.dataclass
class NPGState:
  params: GaussianMLP
  vf_params: ValueMLP
  vf_opt: torch.optim.Adam
  steps: torch.Tensor           # total env steps, int64
  obs_norm: RunningNorm


def _flat(tensors) -> torch.Tensor:
  return torch.cat([t.reshape(-1) for t in tensors])


def npg_state_from_numpy(npg: "NPG", tree) -> NPGState:
  """Carry a JAX ``NPGState`` (leaves as numpy) into the port: flax
  kernels become ``nn.Linear`` weights, optax's Adam state torch Adam's;
  the JAX key has no counterpart (draws are given to ``train_step``)."""
  obs_dim = int(np.asarray(
      tree.params["params"]["Dense_0"]["kernel"]).shape[0])
  policy, vf = npg.make_nets(obs_dim, torch.Generator(device=npg.device))
  load_flax_params(policy, tree.params)
  load_flax_params(vf, tree.vf_params)
  vf_opt = adam(vf, npg.cfg.vf_learning_rate)
  load_adam_state(vf_opt, vf, tree.vf_opt)
  return NPGState(
      params=policy, vf_params=vf, vf_opt=vf_opt,
      steps=torch.as_tensor(int(np.asarray(tree.steps)), dtype=torch.int64,
                            device=npg.device),
      obs_norm=norm_from_numpy(tree.obs_norm, npg.dtype, npg.device))


class NPG(BatchReductions):
  """NPG trainer bound to a MyoEnv, on one device (the card unless the
  caller asks for the CPU); full-episode trajectory sampling."""

  def __init__(self, env: MyoEnv, config: NPGConfig = NPGConfig(),
               device="cuda"):
    self.env = env
    self.cfg = config
    self.device = torch.device(device)
    self.dtype = env.dtype
    self.horizon = int(env.horizon)
    self.act_dim = int(env.action_dim)

  def make_nets(self, obs_dim: int, generator) -> tuple[GaussianMLP, ValueMLP]:
    cfg, dt, dev = self.cfg, self.dtype, self.device
    policy = GaussianMLP(obs_dim, self.act_dim, cfg.hidden, cfg.init_log_std,
                         cfg.min_log_std, generator, dt, dev)
    return policy, ValueMLP(obs_dim, cfg.vf_hidden, generator, dt, dev)

  # ---- initialization ---------------------------------------------------

  def init(self, seed: int = 0,
           generator: torch.Generator | None = None) -> NPGState:
    g = (generator if generator is not None
         else torch.Generator(device=self.device).manual_seed(seed))
    obs_dim = int(self.env.reset(1, self.device, g).obs.shape[-1])
    policy, vf = self.make_nets(obs_dim, g)
    return NPGState(
        params=policy, vf_params=vf,
        vf_opt=adam(vf, self.cfg.vf_learning_rate),
        steps=torch.zeros((), dtype=torch.int64, device=self.device),
        obs_norm=RunningNorm.create(obs_dim, self.dtype, self.device))

  def draw(self, generator: torch.Generator) -> dict:
    """Action noise [T, N, A] and value-fit permutations [epochs, N*T]."""
    cfg, T, N = self.cfg, self.horizon, self.cfg.num_envs
    noise = torch.randn((T, N, self.act_dim), generator=generator,
                        dtype=self.dtype, device=self.device)
    # argsort of float64 uniforms: a uniform permutation (ties ~2^-53)
    perms = torch.rand((cfg.vf_epochs, N * T), generator=generator,
                       dtype=torch.float64, device=self.device).argsort(dim=-1)
    return dict(noise=noise, perms=perms)

  # ---- the parts of one iteration ---------------------------------------

  @torch.no_grad()
  def rollout(self, ts: NPGState, noise: torch.Tensor,
              generator: torch.Generator | None = None) -> dict:
    """N fresh episodes of T steps (mjrl trajectory mode); fields [T, N]."""
    cfg, T, N = self.cfg, self.horizon, self.cfg.num_envs
    st = self.env.reset(N, self.device, generator)
    live = torch.ones(N, dtype=self.dtype, device=self.device)
    traj: dict[str, list] = {k: [] for k in (
        "obs", "obs_raw", "act", "logp", "reward", "live", "tfrac",
        "solved")}
    for t in range(T):
      obs = (ts.obs_norm.apply(st.obs, cfg.norm_clip)
             if cfg.normalize_obs else st.obs)
      mean, log_std = ts.params(obs)
      act = mean + torch.exp(log_std) * noise[t]
      logp = gaussian_logp(mean, log_std, act)
      nxt = self.env.step(st, act.clamp(-1.0, 1.0), generator)
      for k, v in (
          ("obs", obs), ("obs_raw", st.obs), ("act", act), ("logp", logp),
          ("reward", nxt.info["rwd_dense"] * live), ("live", live),
          ("tfrac", torch.full((N,), t / T, dtype=self.dtype,
                               device=self.device)),
          ("solved", nxt.info["solved"].to(self.dtype) * live)):
        traj[k].append(v)
      live = live * (1.0 - nxt.done.to(self.dtype))
      st = nxt
    return {k: torch.stack(v) for k, v in traj.items()}

  @torch.no_grad()
  def gae(self, ts: NPGState, traj: dict) -> dict:
    """GAE with the time-featured baseline and no bootstrap past the
    horizon (mjrl treats truncation as absorbing). Returns the batch
    flattened to N*T samples: obs, act, logp, adv (standardized over the
    whole batch, dead steps included, as the reference), live, tfrac and
    the baseline's regression targets ret."""
    cfg, T = self.cfg, self.horizon
    live = traj["live"]
    values = ts.vf_params(traj["obs"], traj["tfrac"]) * live
    gae = torch.zeros_like(values[0])
    advs = torch.empty_like(values)
    for t in range(T - 1, -1, -1):
      next_v = values[t + 1] if t + 1 < T else 0.0
      delta = traj["reward"][t] + cfg.gamma * next_v - values[t]
      gae = delta + cfg.gamma * cfg.gae_lambda * gae * live[t]
      advs[t] = gae
    advs = advs * live
    returns = advs + values
    adv_mean, adv_std = self.moments(advs)
    advs = (advs - adv_mean) / (adv_std + 1e-6)
    advs = advs * live
    obs = traj["obs"]
    return dict(obs=obs.reshape(-1, obs.shape[-1]),
                act=traj["act"].reshape(-1, traj["act"].shape[-1]),
                logp=traj["logp"].reshape(-1), adv=advs.reshape(-1),
                live=live.reshape(-1), tfrac=traj["tfrac"].reshape(-1),
                ret=returns.reshape(-1))

  @staticmethod
  def mean_kl(policy: GaussianMLP, batch: dict, mean0: torch.Tensor,
              log_std0: torch.Tensor,
              denom: torch.Tensor | None = None) -> torch.Tensor:
    """KL(pi_old || pi) summed over the batch's live samples, over
    ``denom`` (default: their count)."""
    mean, log_std = policy(batch["obs"])
    var0, var = torch.exp(2 * log_std0), torch.exp(2 * log_std)
    kl = torch.sum(log_std - log_std0
                   + (var0 + torch.square(mean0 - mean)) / (2.0 * var) - 0.5,
                   dim=-1)
    live = batch["live"]
    if denom is None:
      denom = live.sum().clamp_min(1.0)
    return torch.sum(kl * live) / denom

  def natural_gradient(self, ts: NPGState, batch: dict) -> dict:
    """One KL-normalized natural-gradient step of ``ts.params``, in place.
    Returns the step's alpha and the surrogate gradient's norm."""
    cfg = self.cfg
    policy = ts.params
    params = list(policy.parameters())
    live = batch["live"]
    denom = self.batch_sum(live.sum()).clamp_min(1.0)

    mean, log_std = policy(batch["obs"])
    ratio = torch.exp(gaussian_logp(mean, log_std, batch["act"])
                      - batch["logp"])
    surrogate = torch.sum(ratio * batch["adv"] * live) / denom
    g = self.batch_sum(_flat(torch.autograd.grad(surrogate, params)))
    mean0, log_std0 = mean.detach(), log_std.detach()

    # F v = Hessian of the mean KL at theta0 times v: one forward and one
    # backward with create_graph, then one backward per product
    kl_grad = _flat(torch.autograd.grad(
        self.mean_kl(policy, batch, mean0, log_std0, denom), params,
        create_graph=True))

    def fvp(v):
      hv = torch.autograd.grad(kl_grad @ v, params, retain_graph=True)
      return self.batch_sum(_flat(hv)) + cfg.cg_damping * v

    x = torch.zeros_like(g)
    r, p, rr = g, g, g @ g
    for _ in range(cfg.cg_iters):
      fp = fvp(p)
      alpha = rr / (p @ fp).clamp_min(1e-12)
      x = x + alpha * p
      r = r - alpha * fp
      rr_new = r @ r
      p = r + (rr_new / rr.clamp_min(1e-12)) * p
      rr = rr_new

    # KL-normalized step: alpha = sqrt(2 * delta / (g^T F^-1 g))
    gHg = (g @ x).clamp_min(1e-12)
    alpha = torch.sqrt(2.0 * cfg.step_size / gHg)
    with torch.no_grad():
      theta = nn.utils.parameters_to_vector(params) + alpha * x
      nn.utils.vector_to_parameters(theta, params)
    return dict(kl_step_alpha=alpha.detach(),
                grad_norm=torch.linalg.vector_norm(g))

  def fit_value(self, ts: NPGState, batch: dict,
                perms: torch.Tensor) -> torch.Tensor:
    """Adam minibatch epochs of the baseline on the Monte-Carlo targets, in
    place; ``perms[epoch]`` orders the samples. Returns the mean loss."""
    bs = self.cfg.vf_batch_size
    n_mb = max(1, perms.shape[-1] // bs)
    vf, opt = ts.vf_params, ts.vf_opt
    epoch_losses = []
    for perm in perms:
      losses = []
      for i in range(n_mb):
        idx = perm[i * bs:(i + 1) * bs]
        w = batch["live"][idx]
        v = vf(batch["obs"][idx], batch["tfrac"][idx])
        loss = (torch.sum(w * torch.square(v - batch["ret"][idx]))
                / w.sum().clamp_min(1.0))
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
      epoch_losses.append(torch.stack(losses).mean())
    return torch.stack(epoch_losses).mean()

  # ---- one training iteration ------------------------------------------

  def train_step(self, ts: NPGState, generator: torch.Generator):
    return self.train_step_from(ts, **self.draw(generator),
                                generator=generator)

  def train_step_from(self, ts: NPGState, noise: torch.Tensor,
                      perms: torch.Tensor,
                      generator: torch.Generator | None = None):
    cfg = self.cfg
    traj = self.rollout(ts, noise, generator)
    obs_norm = (self.norm_update(ts.obs_norm, traj["obs_raw"])
                if cfg.normalize_obs else ts.obs_norm)
    batch = self.gae(ts, traj)
    step = self.natural_gradient(ts, batch)
    T = self.horizon

    def whole(x):      # [T * n, ...] of this process's envs -> [T * N, ...]
      x = self.gather_envs(x.reshape((T, -1) + tuple(x.shape[1:])))
      return x.reshape((-1,) + tuple(x.shape[2:]))

    vf_loss = self.fit_value(
        ts, {k: whole(batch[k]) for k in ("obs", "tfrac", "ret", "live")},
        perms)
    live_sum = self.batch_sum(traj["live"].sum()).clamp_min(1.0)
    metrics = dict(
        stoc_pol_mean=self.batch_mean(traj["reward"].sum(0).mean()),
        reward_mean=self.batch_sum(traj["reward"].sum()) / live_sum,
        solved_frac=self.batch_sum(traj["solved"].sum()) / live_sum,
        kl_step_alpha=step["kl_step_alpha"],
        vf_loss=vf_loss,
        grad_norm=step["grad_norm"])
    new_ts = NPGState(params=ts.params, vf_params=ts.vf_params,
                      vf_opt=ts.vf_opt,
                      steps=ts.steps + cfg.num_envs * self.horizon,
                      obs_norm=obs_norm)
    return new_ts, metrics

  # ---- evaluation -------------------------------------------------------

  @torch.no_grad()
  def eval_step(self, ts: NPGState, num_envs: int = 32,
                generator: torch.Generator | None = None) -> dict:
    """Deterministic-policy fresh-episode eval: an episode succeeds when
    solved on more than 5 steps (the reference's evaluate_success)."""
    cfg = self.cfg
    st = self.env.reset(num_envs, self.device, generator)
    cnt = torch.zeros(num_envs, dtype=self.dtype, device=self.device)
    rew = torch.zeros_like(cnt)
    solveds = []
    for _ in range(self.horizon):
      obs = (ts.obs_norm.apply(st.obs, cfg.norm_clip)
             if cfg.normalize_obs else st.obs)
      mean, _ = ts.params(obs)
      st = self.env.step(st, mean.clamp(-1.0, 1.0), generator)
      solved = st.info["solved"].to(self.dtype)
      cnt = cnt + solved
      rew = rew + st.info["rwd_dense"]
      solveds.append(solved)
    return dict(eval_solved_frac=torch.stack(solveds).mean(),
                eval_success=(cnt > 5.0).to(self.dtype).mean(),
                eval_score=rew.mean())

  # ---- training loop ----------------------------------------------------

  def train(self, total_env_steps: int, seed: int = 0,
            progress: Callable | None = None, eval_every: int = 0,
            writer=None):
    """Run training; returns (NPGState, list of metric dicts).

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
    per_iter = cfg.num_envs * self.horizon
    iters = max(1, total_env_steps // per_iter)
    history = []
    t0 = time.time()
    for it in range(iters):
      ts, metrics = self.train_step(ts, generator)
      if eval_every and ((it + 1) % eval_every == 0 or it == iters - 1):
        metrics = {**metrics, **self.eval_step(ts, generator=eval_gen)}
      metrics = metrics_to_host(metrics)
      metrics_mod.check_finite(metrics, where=f"NPG iter {it}")
      metrics["wall"] = time.time() - t0
      metrics["env_steps"] = (it + 1) * per_iter
      metrics["steps_per_s"] = round(
          (it + 1) * per_iter / max(metrics["wall"], 1e-9), 1)
      history.append(metrics)
      if writer is not None:
        writer.write(metrics["env_steps"], metrics)
      if progress is not None:
        progress(it, metrics)
    return ts, history
