"""SISL Pursuit (``pursuit_v4``), natively batched (port of
``cleanmarl_tpu/envs/pursuit.py``).

The rules of the JAX module, which ports the installed PettingZoo
``pursuit_base.py`` rule for rule (see its docstring):

- a 16×16 grid with the centred rectangle building; actions [left,
  right, up, down, stay] = [[-1,0],[1,0],[0,1],[0,-1],[0,0]], a move into
  the building or out of the grid stays put;
- the pursuers move one at a time; after each sub-move every pursuer's
  tag count (evaders of the step's start in its 4-neighbourhood, the
  coordinates clipped into the grid, so border cells count twice) earns
  ``tag_reward`` shared over the pursuers, divided by P·P and summed over
  the P sub-moves;
- then the captures against the evaders of the step's start: an alive
  evader is caught when its occupied catch positions equal the static
  ``need_to_surround`` (with upstream's strict-bounds quirk), or, without
  ``surround``, when ``n_catch`` pursuers share its cell; ``catch_reward``
  goes to each surrounding pursuer, shared over P, plus ``urgency_reward``;
- then every evader (caught ones too, which stay dead) takes a uniform
  random action with the same blocked-move rule (``_evader_actions``);
- obs per pursuer: the 7×7×3 window [walls, pursuer counts, alive-evader
  counts] around it, laid out as upstream's ``swapaxes((3,R,R), 2, 0)``
  then flattened; state = the obs concatenated; every action available;
- the episode ends when every evader is caught and truncates at
  ``time_limit``.

Every state field carries a leading env axis. A pursuer's move is blocked
by bounds and the building only, so all P moves are taken at once and the
tag total after each sub-move comes from the old and new cells' tag counts
(a cumulative sum over the pursuers: the same sequence of totals as moving
them one at a time); counts are scattered with
``index_put_(accumulate=True)`` (small integers in float32, exact); the obs
windows are one gather with a precomputed index. Spawn places the
pursuers, then the evaders, one at a time, uniformly over the open cells
not on or next to an already placed member of the group (one Gumbel-max
draw per placement over pre-drawn noise, each placement closing its cells
in the noise of the placements after it).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cleanmarl_tpu_torch.core.device import resolve_device
from cleanmarl_tpu_torch.envs.base import Environment
from cleanmarl_tpu_torch.types import TimeStep

# [left, right, up, down, stay]; x is the first grid dimension upstream
MOTION = np.array([[-1, 0], [1, 0], [0, 1], [0, -1], [0, 0]], np.int64)
# the 4-neighbourhood of tags and surround captures
SURROUND = np.array([[-1, 0], [1, 0], [0, 1], [0, -1]], np.int64)


def rectangle_map(xs: int, ys: int, xb: float = 0.3, yb: float = 0.2):
    """two_d_maps.rectangle_map: 1 where the centred building sits."""
    xi = np.arange(xs, dtype=np.float64) / xs
    yi = np.arange(ys, dtype=np.float64) / ys
    bx = (xi > xb) & (xi < 1.0 - xb)
    by = (yi > yb) & (yi < 1.0 - yb)
    return (bx[:, None] & by[None, :]).astype(np.float32)


def need_to_surround_table(x_size: int, y_size: int, bmap: np.ndarray) -> np.ndarray:
    """Pursuers needed to surround each cell (pursuit_base.py:585-603): 4,
    minus 1 per x or y border, minus each building neighbour, where the
    neighbour's bounds check is the strict 0 < xn < X (so neighbours on
    the border row or column are never counted)."""
    need = np.full((x_size, y_size), 4, np.int64)
    for x in range(x_size):
        for y in range(y_size):
            need[x, y] -= (x in (0, x_size - 1)) + (y in (0, y_size - 1))
            for dx, dy in SURROUND:
                xn, yn = x + dx, y + dy
                if 0 < xn < x_size and 0 < yn < y_size and bmap[xn, yn] == 1.0:
                    need[x, y] -= 1
    return need


@dataclasses.dataclass(frozen=True)
class PursuitState:
    ppos: torch.Tensor    # (N, P, 2) int64
    epos: torch.Tensor    # (N, E, 2) int64
    ealive: torch.Tensor  # (N, E) bool
    t: torch.Tensor       # (N,) int64


class Pursuit(Environment):
    def __init__(self, x_size: int = 16, y_size: int = 16, n_evaders: int = 30,
                 n_pursuers: int = 8, obs_range: int = 7, n_catch: int = 2,
                 freeze_evaders: bool = False, tag_reward: float = 0.01,
                 catch_reward: float = 5.0, urgency_reward: float = -0.1,
                 surround: bool = True, time_limit: int = 500, device="cuda"):
        self.x_size, self.y_size = x_size, y_size
        self.n_evaders, self.n_pursuers = n_evaders, n_pursuers
        self.obs_range = obs_range
        self.obs_offset = off = (obs_range - 1) // 2
        self.n_catch = n_catch
        self.freeze_evaders = freeze_evaders
        self.tag_reward = tag_reward
        self.catch_reward = catch_reward
        self.urgency_reward = urgency_reward
        self.surround = surround
        self.n_agents = n_pursuers
        self.n_actions = 5
        self.obs_dim = obs_range * obs_range * 3
        self.state_dim = self.obs_dim * n_pursuers
        self.episode_limit = time_limit
        self.device = dev = resolve_device(device)

        # each placement blocks at most 5 cells of its group's free mask;
        # exhausting it would make the masked draw return an arbitrary cell
        bmap = rectangle_map(x_size, y_size)
        open_cells = x_size * y_size - int(bmap.sum())
        for group, n in (("n_pursuers", n_pursuers), ("n_evaders", n_evaders)):
            if n * 5 > open_cells:
                raise ValueError(
                    f"{group}={n} may exhaust the {open_cells} open cells "
                    f"(conservative bound: 5 cells blocked per agent)"
                )

        X, Y = x_size, y_size
        self._motion = torch.as_tensor(MOTION, device=dev)
        self._surround = torch.as_tensor(SURROUND, device=dev)
        self._hi = torch.tensor([X - 1, Y - 1], device=dev)
        self._building = torch.as_tensor(bmap.reshape(-1) > 0, device=dev)      # (X*Y,)
        self._need = torch.as_tensor(need_to_surround_table(X, Y, bmap).reshape(-1),
                                     device=dev)
        # spawn: the free mask starts at 0 on open cells and -inf on the
        # building; a placement blocks its cell and its clipped 4 neighbours
        self._spawn_mask0 = torch.as_tensor(np.where(bmap.reshape(-1) > 0, -np.inf, 0.0)
                                            .astype(np.float32), device=dev)
        xy = np.stack(np.meshgrid(np.arange(X), np.arange(Y), indexing="ij"), -1)
        nb = np.clip(xy[:, :, None, :] + np.concatenate([[[0, 0]], SURROUND])[None, None],
                     0, [X - 1, Y - 1])
        self._spawn_block = torch.as_tensor((nb[..., 0] * Y + nb[..., 1]).reshape(X * Y, 5),
                                            device=dev)
        # obs: the walls channel padded by the obs offset (1 outside the
        # grid, the building inside), and the window gather index: element
        # (yw, xw, c) of a window whose padded top-left is (x, y) is cell
        # (c, x + xw, y + yw) of the (3, X', Y') grid
        self._xp, self._yp = Xp, Yp = X + 2 * off, Y + 2 * off
        walls = np.ones((Xp, Yp), np.float32)
        walls[off:off + X, off:off + Y] = bmap
        self._walls = torch.as_tensor(walls.reshape(-1), device=dev)
        R = obs_range
        yw, xw, c = np.meshgrid(np.arange(R), np.arange(R), np.arange(3), indexing="ij")
        self._window = torch.as_tensor((c * Xp * Yp + xw * Yp + yw).reshape(-1), device=dev)
        # the pursuers' counts go to channel 1, the evaders' to channel 2
        self._count_channel = torch.as_tensor([1] * n_pursuers + [2] * n_evaders, device=dev)

    # -- helpers --------------------------------------------------------
    def _flat(self, pos: torch.Tensor) -> torch.Tensor:
        return pos[..., 0] * self.y_size + pos[..., 1]

    def _blocked_move(self, pos, action):
        """pos (..., 2), action (...) → new pos; bounds and building both
        cancel the move."""
        cand = pos + self._motion[action]
        inb = ((cand >= 0) & (cand <= self._hi)).all(-1)
        safe = torch.minimum(torch.clamp(cand, min=0), self._hi)
        ok = inb & ~self._building[self._flat(safe)]
        return torch.where(ok[..., None], cand, pos)

    def _count_grid(self, pos, alive=None):
        """(N, K, 2) positions → (N, X·Y) float counts."""
        n = pos.shape[0]
        cells = self.x_size * self.y_size
        idx = self._flat(pos) + torch.arange(n, device=self.device)[:, None] * cells
        w = (torch.ones(pos.shape[:2], device=self.device) if alive is None
             else alive.float())
        return torch.zeros(n * cells, device=self.device).index_put_(
            (idx.reshape(-1),), w.reshape(-1), accumulate=True).reshape(n, cells)

    def _lookup(self, grid, pos):
        """grid (N, X·Y) at positions (N, K[, 4], 2) → (N, K[, 4])."""
        n = pos.shape[0]
        return torch.gather(grid, 1, self._flat(pos).reshape(n, -1)).reshape(pos.shape[:-1])

    def _tags(self, ppos, egrid):
        """Per-pursuer evader count over the clipped 4-neighbourhood."""
        nb = ppos[:, :, None, :] + self._surround                      # (N,P,4,2)
        nb = torch.minimum(torch.clamp(nb, min=0), self._hi)
        return self._lookup(egrid, nb).sum(-1)                         # (N,P)

    def _spawn_group(self, generator, num_envs: int, n: int):
        """n sequential placements per env → (N, n, 2): placement k takes
        the argmax of its Gumbel noise over the cells still open, then
        closes its cell and neighbours in the noise of the placements
        after it."""
        XY = self.x_size * self.y_size
        u = torch.rand((n, num_envs, XY), generator=generator, device=self.device)
        score = self._spawn_mask0 - torch.log(
            -torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
        cells = torch.empty((n, num_envs), dtype=torch.int64, device=self.device)
        for k in range(n):
            torch.argmax(score[k], dim=-1, out=cells[k])
            if k + 1 < n:
                block = self._spawn_block[cells[k]]                       # (N, 5)
                score[k + 1:].scatter_(2, block.expand(n - k - 1, num_envs, 5),
                                       float("-inf"))
        cells = cells.t()
        return torch.stack([cells // self.y_size, cells % self.y_size], dim=-1)

    def _evader_actions(self, generator, shape):
        """The evaders' uniform random actions of one step."""
        return torch.randint(0, self.n_actions, shape, generator=generator,
                             device=self.device)

    # -- Environment API ------------------------------------------------
    def _reset(self, num_envs: int, generator):
        dev = self.device
        s = PursuitState(
            ppos=self._spawn_group(generator, num_envs, self.n_pursuers),
            epos=self._spawn_group(generator, num_envs, self.n_evaders),
            ealive=torch.ones((num_envs, self.n_evaders), dtype=torch.bool, device=dev),
            t=torch.zeros((num_envs,), dtype=torch.int64, device=dev))
        zf = torch.zeros((num_envs,), device=dev)
        fb = torch.zeros((num_envs,), dtype=torch.bool, device=dev)
        return s, self._timestep(s, zf, fb, fb)

    def _step(self, s: PursuitState, actions, generator):
        P = self.n_pursuers
        actions = actions.long()
        egrid = self._count_grid(s.epos, s.ealive)

        # ---- the pursuers move one at a time, tags after each ----------
        # a move is blocked by bounds and the building only, never by
        # another pursuer, so every pursuer's new cell is known at once;
        # after sub-move k pursuers 0..k stand on their new cells and the
        # others on their old ones, which gives each sub-move's tag total
        ppos = self._blocked_move(s.ppos, actions)
        old_tags, new_tags = self._tags(s.ppos, egrid), self._tags(ppos, egrid)   # (N,P)
        totals = old_tags.sum(-1, keepdim=True) + torch.cumsum(new_tags - old_tags, dim=-1)
        reward = (totals * self.tag_reward / (P * P)).sum(-1)

        # ---- captures after the last sub-move -------------------------
        pgrid = self._count_grid(ppos)
        enb = s.epos[:, :, None, :] + self._surround                   # (N,E,4,2)
        enb_inb = ((enb >= 0) & (enb <= self._hi)).all(-1)
        enb_safe = torch.minimum(torch.clamp(enb, min=0), self._hi)
        occ = enb_inb & (self._lookup(pgrid, enb_safe) > 0.0)          # (N,E,4)
        if self.surround:
            caught = s.ealive & (occ.sum(-1) == self._need[self._flat(s.epos)])
            # a pursuer surrounds when it sits on an occupied catch
            # position of a caught evader
            same_cell = (ppos[:, :, None, None, :] == enb_safe[:, None]).all(-1)
            purs_sur = (same_cell & (caught[..., None] & occ)[:, None]).flatten(2).any(-1)
        else:
            caught = s.ealive & (self._lookup(pgrid, s.epos) >= self.n_catch)
            purs_sur = ((ppos[:, :, None] == s.epos[:, None]).all(-1)
                        & caught[:, None, :]).any(-1)
        reward = reward + (self.catch_reward * purs_sur.float().sum(-1) / P
                           + self.urgency_reward)
        ealive = s.ealive & ~caught

        # ---- the evaders' random walk (after removal) ------------------
        epos = s.epos
        if not self.freeze_evaders:
            epos = self._blocked_move(epos, self._evader_actions(generator, ealive.shape))

        t2 = s.t + 1
        done = ~ealive.any(-1)
        truncated = (t2 >= self.episode_limit) & ~done
        s2 = PursuitState(ppos=ppos, epos=epos, ealive=ealive, t=t2)
        return s2, self._timestep(s2, reward, done, truncated)

    def _timestep(self, s, reward, done, truncated) -> TimeStep:
        obs = self._observe(s)
        n = obs.shape[0]
        return TimeStep(
            obs=obs, state=obs.reshape(n, -1),
            avail=torch.ones((n, self.n_pursuers, self.n_actions), dtype=torch.bool,
                             device=self.device),
            reward=reward, done=done, truncated=truncated,
            info={"battle_won": torch.zeros((n,), device=self.device)})

    def _observe(self, s: PursuitState) -> torch.Tensor:
        """(N, P, obs_dim): the flattened 7×7×3 windows."""
        n, off, dev = s.ppos.shape[0], self.obs_offset, self.device
        plane = self._xp * self._yp
        grid = torch.zeros((n, 3, plane), device=dev)
        grid[:, 0] = self._walls
        pos = torch.cat([s.ppos, s.epos], dim=1) + off                 # padded coords
        idx = (torch.arange(n, device=dev)[:, None] * 3 + self._count_channel) * plane \
            + pos[..., 0] * self._yp + pos[..., 1]
        w = torch.cat([torch.ones((n, self.n_pursuers), device=dev), s.ealive.float()], dim=1)
        grid = grid.reshape(-1).index_put_((idx.reshape(-1),), w.reshape(-1),
                                           accumulate=True).reshape(n, -1)
        corner = s.ppos[..., 0] * self._yp + s.ppos[..., 1]            # (N,P)
        win = (corner[..., None] + self._window).reshape(n, -1)
        return torch.gather(grid, 1, win).reshape(n, self.n_pursuers, self.obs_dim)
