"""Exact dynamic-programming solvers for the fishing MDP, on the device.

Counterpart of ``gym_fishing_tpu/agents/dp.py``: RL results are judged
against the true optimum of the discretized MDP.

- `build_mdp` discretizes stock into S cells and quota into A levels and
  integrates the engine's process-noise law (additive normal or lognormal)
  over the cells: a dense transition tensor ``P[A, S, S]`` and a reward
  matrix ``R[A, S]``, in the params' dtype (float64 where they are).
- `value_iteration` applies the Bellman operator, one ``[A*S, S] @ [S]``
  product a sweep, until the sup-norm residual falls below
  ``tol * (1 - gamma) / gamma``. The sweeps run in blocks on the device,
  each keeping its residual and its V there, and the host reads a block's
  residuals once: the solution is the first sweep below the threshold, the
  sweep the JAX package's ``lax.while_loop`` stops at, and the sweep count
  is part of the result.
- `finite_horizon` does backward induction over the horizon (gamma = 1
  allowed), `policy_evaluation` iterates ``V = R_pi + gamma P_pi V`` for a
  quota rule, in blocks as value iteration does.
- `dp` wraps the solved policy in the ``.predict`` contract of the
  closed-form baselines.

Semantics follow the engine's step order: harvest ``h = min(x, q)``, growth,
noise, clip at 0; reward ``price h - cost q^2 - collapse_penalty [x' <= 0]``;
stock 0 is absorbing with zero reward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from gym_fishing_tpu_torch.agents.policies import _PolicyBase
from gym_fishing_tpu_torch.core.env import Env
from gym_fishing_tpu_torch.core.types import MIXTURE, EnvParams
from gym_fishing_tpu_torch.dynamics.growth import get_growth_fn

_DET_EPS = 1e-12  # noise scale below which a transition is treated as a delta
SWEEP_BLOCK = 128  # Bellman sweeps queued on the device between two host reads


@dataclasses.dataclass(frozen=True)
class MDP:
    """Discretized MDP. grid[0] = 0 is the absorbing collapsed state."""

    grid: Any    # [S] stock levels (cell representatives)
    quotas: Any  # [A] quota levels
    P: Any       # [A, S, S] transition probabilities (rows sum to 1)
    R: Any       # [A, S] expected one-step reward


@dataclasses.dataclass(frozen=True)
class DPSolution:
    grid: Any          # [S] stock grid
    quotas: Any        # [A] quota grid
    V: Any             # [S] optimal value
    Q: Any             # [A, S] optimal state-action value
    policy_quota: Any  # [S] greedy quota per state
    iterations: int    # Bellman sweeps performed
    residual: Any      # 0-d: sup-norm of the last counted sweep


def _interp_rows(grid, mu):
    """Delta-at-mu rows: linear-interpolation weights of mu onto `grid`.

    mu: [...] -> rows [..., S]; exact two-point hat weights on the sorted
    grid, clipped to the grid range.
    """
    S = grid.shape[0]
    mu = torch.clamp(mu, grid[0], grid[-1])
    hi = torch.clamp(torch.searchsorted(grid, mu.contiguous(), right=True), 1, S - 1)
    lo = hi - 1
    w = (mu - grid[lo]) / (grid[hi] - grid[lo])
    eye = torch.eye(S, dtype=mu.dtype, device=mu.device)
    return eye[lo] * (1.0 - w)[..., None] + eye[hi] * w[..., None]


def _params(env: Env, params: Optional[EnvParams], device) -> EnvParams:
    """`params`, or the env's defaults on `device` (default: the card)."""
    return params if params is not None else env.params(device=device)


def build_mdp(env: Env, params: Optional[EnvParams] = None, *, n_states: int = 256,
              n_quotas: int = 128, x_max: Optional[float] = None, device=None) -> MDP:
    """Discretize the env into a dense tabular MDP on the params' device.

    State 0 is exactly x = 0 (collapsed, absorbing); states 1..S-1 are
    uniform cells over (0, x_max] represented by their midpoints. Mass below
    0 lands in state 0, mass above x_max in the top cell. x_max defaults to
    2K.
    """
    if env.config.growth == MIXTURE:
        raise ValueError(
            "build_mdp needs a single growth model; solve each mixture "
            "component separately (growth=GROWTH_MODELS[model_idx])"
        )
    p = _params(env, params, device)
    dtype, dev = p.dtype, p.device

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    K = t(p.K)
    xm = t(2.0 * K if x_max is None else x_max)
    S, A = n_states, n_quotas
    dx = xm / (S - 1)
    grid = torch.cat([torch.zeros(1, dtype=dtype, device=dev),
                      (torch.arange(1, S, device=dev) - 0.5).to(dtype) * dx])
    # cell edges for binning x2: (-inf, 0], (0, dx], ..., ((S-2)dx, +inf)
    inner = torch.arange(0, S - 1, dtype=dtype, device=dev) * dx
    # jnp.linspace(0, stop, n)'s arithmetic: stop * (i / (n - 1))
    quotas = xm * (torch.arange(A, dtype=dtype, device=dev) / (A - 1))

    growth = get_growth_fn(env.config.growth)
    x = grid[None, :]                      # [1, S]
    q = quotas[:, None]                    # [A, 1]
    h = torch.minimum(x, q)                # [A, S]
    x1 = x - h
    mu = growth(p, x1)
    one = torch.ones((), dtype=dtype, device=dev)

    if env.config.noise_form == "additive":
        # x2 ~ Normal(mu, sigma x1)
        scale = t(p.sigma) * x1
        det = scale <= _DET_EPS
        safe = torch.where(det, one, scale)
        cdf_inner = torch.special.ndtr((inner[None, None, :] - mu[..., None]) / safe[..., None])
    else:  # lognormal: x2 = mu exp(sigma xi), support (0, inf) for mu > 0
        scale = torch.broadcast_to(t(p.sigma), mu.shape)
        det = (scale <= _DET_EPS) | (mu <= 0.0)
        safe_mu = torch.where(mu > 0.0, mu, one)
        safe = torch.where(det, one, scale)
        edges = inner[None, None, :]
        z = torch.where(
            edges > 0.0,
            torch.log(torch.clamp(edges, min=_DET_EPS) / safe_mu[..., None]) / safe[..., None],
            t(float("-inf")),
        )
        cdf_inner = torch.special.ndtr(z)

    # CDF at all S + 1 edges: F(-inf) = 0, F(inner edges), F(+inf) = 1
    zeros = torch.zeros(mu.shape + (1,), dtype=dtype, device=dev)
    cdf = torch.cat([zeros, cdf_inner, zeros + 1.0], dim=-1)   # [A, S, S + 1]
    P_noisy = torch.diff(cdf, dim=-1)                          # [A, S, S]
    P_det = _interp_rows(grid, torch.clamp(mu, min=0.0))       # [A, S, S]
    P = torch.where(det[..., None], P_det, P_noisy)

    R = t(p.price) * h - t(p.cost) * q * q - t(p.collapse_penalty) * P[..., 0]
    R[:, 0] = 0.0   # the absorbing collapsed state earns nothing
    return MDP(grid=grid, quotas=quotas, P=P, R=R)


def _greedy(mdp: MDP, Q):
    return mdp.quotas[torch.argmax(Q, dim=0)]   # ties: the first index, as jnp.argmax


def _backup(mdp: MDP, g, V):
    """(Q, V') of one Bellman sweep, V'[0] = 0."""
    Q = mdp.R + g * torch.einsum("asj,j->as", mdp.P, V)
    Vn = Q.max(dim=0).values
    Vn[0] = 0.0
    return Q, Vn


def _iterate(step, V0, stop: float, max_iters: int):
    """Apply `step` (V -> V') until the sup-norm change is no longer above
    `stop`, at most `max_iters` times, as a ``lax.while_loop`` on (V,
    residual, i) would: returns (V at that sweep, its residual, sweeps).

    Sweeps are queued SWEEP_BLOCK at a time with their V and residual kept
    on the device; the host reads a block's residuals once and takes the
    first that stops, so the sweeps run past it are discarded."""
    V, resid, done = V0, torch.full((), float("inf"), dtype=V0.dtype, device=V0.device), 0
    while done < max_iters:
        n = min(SWEEP_BLOCK, max_iters - done)
        Vs, rs = [], []
        for _ in range(n):
            Vn = step(V)
            rs.append((Vn - V).abs().max())
            Vs.append(Vn)
            V = Vn
        rs = torch.stack(rs)
        stops = torch.nonzero(~(rs > stop)).flatten().tolist()   # one host read a block
        if stops:
            k = stops[0]
            return Vs[k], rs[k], done + k + 1
        done += n
        resid = rs[-1]
    return V, resid, done


def value_iteration(env: Env, params: Optional[EnvParams] = None, *, gamma: float = 0.99,
                    tol: float = 1e-6, max_iters: int = 20_000, n_states: int = 256,
                    n_quotas: int = 128, x_max: Optional[float] = None,
                    mdp: Optional[MDP] = None, device=None) -> DPSolution:
    """Infinite-horizon discounted value iteration (0 < gamma < 1), stopped
    at the first sweep whose sup-norm residual is at most ``tol (1 - gamma)
    / gamma`` (a value within `tol` of optimal); V and Q are then one sweep
    further, as in the JAX package."""
    if not (0.0 < gamma < 1.0):
        raise ValueError("value_iteration requires 0 < gamma < 1; "
                         "use finite_horizon for gamma=1 episodic optima")
    if mdp is None:
        mdp = build_mdp(env, params, n_states=n_states, n_quotas=n_quotas, x_max=x_max,
                        device=device)
    dtype = mdp.R.dtype
    g = torch.as_tensor(gamma, dtype=dtype, device=mdp.R.device)
    stop = float(torch.as_tensor(tol * (1.0 - gamma) / gamma, dtype=dtype))
    V0 = torch.zeros(mdp.grid.shape, dtype=dtype, device=mdp.R.device)
    V, resid, iters = _iterate(lambda V: _backup(mdp, g, V)[1], V0, stop, max_iters)
    Q, V = _backup(mdp, g, V)
    return DPSolution(grid=mdp.grid, quotas=mdp.quotas, V=V, Q=Q,
                      policy_quota=_greedy(mdp, Q), iterations=iters, residual=resid)


def finite_horizon(env: Env, params: Optional[EnvParams] = None, *, T: Optional[int] = None,
                   gamma: float = 1.0, n_states: int = 256, n_quotas: int = 128,
                   x_max: Optional[float] = None, mdp: Optional[MDP] = None,
                   device=None) -> Tuple[Any, Any, MDP]:
    """Exact backward induction over T steps (default: params.Tmax).

    Returns ``(V, policy_quota, mdp)``: ``V[t, s]`` is the optimal value with
    ``T - t`` steps remaining before step t (``V[0]`` is a fresh episode's)
    and ``policy_quota[t, s]`` the optimal quota at step t. gamma = 1 is the
    optimum of the Tmax-terminated episodic envs.
    """
    p = _params(env, params, device)
    if T is None:
        T = int(torch.as_tensor(p.Tmax))
    if mdp is None:
        mdp = build_mdp(env, p, n_states=n_states, n_quotas=n_quotas, x_max=x_max)
    g = torch.as_tensor(gamma, dtype=mdp.R.dtype, device=mdp.R.device)
    V = torch.zeros(mdp.grid.shape, dtype=mdp.R.dtype, device=mdp.R.device)
    Vs, pols = [], []
    for _ in range(T):
        Q, V = _backup(mdp, g, V)
        Vs.append(V)
        pols.append(_greedy(mdp, Q))
    # index t is the value / policy used at episode step t
    return torch.stack(Vs[::-1]), torch.stack(pols[::-1]), mdp


def policy_evaluation(env: Env, policy_quota, params: Optional[EnvParams] = None, *,
                      gamma: float = 0.99, tol: float = 1e-9, max_iters: int = 100_000,
                      n_states: int = 256, n_quotas: int = 128, x_max: Optional[float] = None,
                      mdp: Optional[MDP] = None, device=None):
    """Exact discounted value V^pi of a quota rule: ``policy_quota`` is a
    callable ``stock -> quota`` (such as ``escapement(env, params).quota``)
    or per-state quotas on the MDP grid. Each state's quota snaps to the
    nearest quota level (the first on ties); then ``V = R_pi + gamma P_pi V``
    is iterated to the fixed point. Returns ``(V, mdp)``."""
    if not (0.0 < gamma < 1.0):
        raise ValueError("policy_evaluation requires 0 < gamma < 1")
    if mdp is None:
        mdp = build_mdp(env, params, n_states=n_states, n_quotas=n_quotas, x_max=x_max,
                        device=device)
    S = mdp.grid.shape[0]
    dtype, dev = mdp.R.dtype, mdp.R.device
    q = policy_quota(mdp.grid) if callable(policy_quota) else policy_quota
    q = torch.as_tensor(q, dtype=dtype, device=dev)
    if q.shape != (S,):
        raise ValueError(f"policy quota must have shape ({S},), got {tuple(q.shape)}")
    a_idx = torch.argmin((q[:, None] - mdp.quotas[None, :]).abs(), dim=-1)   # [S]
    sel = torch.arange(S, device=dev)
    P_pi, R_pi = mdp.P[a_idx, sel, :], mdp.R[a_idx, sel]
    g = torch.as_tensor(gamma, dtype=dtype, device=dev)
    stop = float(torch.as_tensor(tol * (1.0 - gamma) / gamma, dtype=dtype))

    def step(V):
        Vn = R_pi + g * (P_pi @ V)
        Vn[0] = 0.0
        return Vn

    V, _, _ = _iterate(step, torch.zeros(S, dtype=dtype, device=dev), stop, max_iters)
    return V, mdp


def _interp(x, xp, fp):
    """jnp.interp's arithmetic: piecewise-linear through (xp, fp), held at
    the end values outside [xp[0], xp[-1]]; grid steps are never 0 here."""
    x = torch.as_tensor(x, dtype=xp.dtype, device=xp.device)
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.shape[0] - 1)
    f = fp[i - 1] + ((x - xp[i - 1]) / (xp[i] - xp[i - 1])) * (fp[i] - fp[i - 1])
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class dp(_PolicyBase):
    """Optimal DP policy with the ``.predict`` contract: solves the
    discretized MDP by discounted value iteration at construction and
    answers by linear interpolation of the greedy quota on the stock grid.
    Goes wherever `msy` and `escapement` go."""

    def __init__(self, env: Env, params: Optional[EnvParams] = None, *, gamma: float = 0.99,
                 n_states: int = 256, n_quotas: int = 128, **vi_kwargs):
        super().__init__(env, params)
        self.solution = value_iteration(env, self.params, gamma=gamma, n_states=n_states,
                                        n_quotas=n_quotas, **vi_kwargs)

    def quota(self, stock):
        s = self.solution
        return _interp(stock, s.grid, s.policy_quota)
