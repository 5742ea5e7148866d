"""SMAClite micro-combat, frozen for the benchmark's reference.

A copy of the rules, constants, observation and state layouts and the
scripted enemy of the program's batched SMAClite env, kept here so that
the reference the benchmark judges the program by does not move when the
program is edited. It imports nothing of the program. ``reset`` draws the
spawn jitter from the caller's ``torch.Generator`` in the same order and
shapes as the program, so the same generator gives the same episodes.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from benchmark.reference.common import TimeStep

UNIT_TYPES = {
    "marine":   dict(hp=45.0,  shield=0.0,  dmg=6.0,  cd=1.0, rng=6.0,
                     speed=3.15),
    "stalker":  dict(hp=80.0,  shield=80.0, dmg=13.0, cd=2.0, rng=6.0,
                     speed=4.13),
    "zealot":   dict(hp=100.0, shield=50.0, dmg=16.0, cd=1.0, rng=1.5,
                     speed=3.15),
    "marauder": dict(hp=125.0, shield=0.0,  dmg=12.0, cd=2.0, rng=6.0,
                     speed=3.15),
    "medivac":  dict(hp=150.0, shield=0.0,  dmg=8.0,  cd=1.0, rng=4.0,
                     heal=True, speed=4.13),
}
TYPE_ORDER = ("marine", "stalker", "zealot", "marauder", "medivac")

ORDER_RANGE = 6.0
SIGHT_RANGE = 9.0
PURSUE_MARGIN = 2.0
MOVE_AMOUNT = 2.0
BASE_SPEED = 3.15
MAP_SIZE = 32.0
REWARD_KILL = 10.0
REWARD_WIN = 200.0
REWARD_SCALE = 20.0
SHIELD_REGEN = 2.0
UNIT_RADIUS = 0.5     # collision radius of the opt-in unit_collisions push-out

N_FIXED_ACTIONS = 6   # no-op, stop, N, S, E, W
_MOVE_DIRS = ((0.0, 1.0), (0.0, -1.0), (1.0, 0.0), (-1.0, 0.0))


@dataclasses.dataclass(frozen=True)
class SmacState:
    ally_pos: torch.Tensor      # (N, A, 2)
    ally_hp: torch.Tensor       # (N, A)
    ally_shield: torch.Tensor   # (N, A)
    ally_cd: torch.Tensor       # (N, A)
    enemy_pos: torch.Tensor     # (N, E, 2)
    enemy_hp: torch.Tensor      # (N, E)
    enemy_shield: torch.Tensor  # (N, E)
    enemy_cd: torch.Tensor      # (N, E)
    enemy_target: torch.Tensor  # (N, E) int64; -1 = no acquired target
    last_action: torch.Tensor   # (N, A) int64
    t: torch.Tensor             # (N,) int64


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-env lookup along the unit axis: x (N, U[, 2]), idx (N, K)."""
    if x.dim() == 3:
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return torch.gather(x, 1, idx)


def _scatter_add(n_units: int, idx: torch.Tensor, val: torch.Tensor):
    out = torch.zeros(idx.shape[:1] + (n_units,), dtype=val.dtype,
                      device=val.device)
    return out.scatter_add_(1, idx, val)


class MicroCombat:
    def __init__(self, ally_types, enemy_types, time_limit: int = 150,
                 unit_collisions: bool = False, device="cuda"):
        self.unit_collisions = unit_collisions
        self.device = dev = torch.device(device)
        if isinstance(ally_types, int):
            ally_types = ["marine"] * ally_types
        if isinstance(enemy_types, int):
            enemy_types = ["marine"] * enemy_types
        self.ally_types = list(ally_types)
        self.enemy_types = list(enemy_types)
        self.n_agents = A = len(ally_types)
        self.n_enemies = E = len(enemy_types)
        self.episode_limit = time_limit
        self.ally_heals = any(UNIT_TYPES[t].get("heal", False) for t in ally_types)
        self.enemy_heals = any(UNIT_TYPES[t].get("heal", False) for t in enemy_types)
        n_targets = max(E, A) if self.ally_heals else E
        self.n_actions = N_FIXED_ACTIONS + n_targets

        def stat(types: List[str], key: str):
            return torch.tensor([UNIT_TYPES[t][key] for t in types],
                                dtype=torch.float32, device=dev)

        def move(types):
            # ratio formed in Python float64 first, as in the JAX module
            return torch.tensor(
                [UNIT_TYPES[t]["speed"] / BASE_SPEED * MOVE_AMOUNT for t in types],
                dtype=torch.float32, device=dev,
            )

        def heal(types):
            return torch.tensor([UNIT_TYPES[t].get("heal", False) for t in types],
                                dtype=torch.bool, device=dev)

        self.a_max_hp, self.e_max_hp = stat(ally_types, "hp"), stat(enemy_types, "hp")
        self.a_max_sh, self.e_max_sh = (stat(ally_types, "shield"),
                                        stat(enemy_types, "shield"))
        self.a_dmg, self.e_dmg = stat(ally_types, "dmg"), stat(enemy_types, "dmg")
        self.a_cd, self.e_cd = stat(ally_types, "cd"), stat(enemy_types, "cd")
        self.a_rng, self.e_rng = stat(ally_types, "rng"), stat(enemy_types, "rng")
        self.a_move, self.e_move = move(ally_types), move(enemy_types)
        self.a_heal, self.e_heal = heal(ally_types), heal(enemy_types)
        self.move_dirs = torch.tensor(_MOVE_DIRS, dtype=torch.float32, device=dev)

        all_types = set(ally_types) | set(enemy_types)
        self.has_shields = any(UNIT_TYPES[t]["shield"] > 0 for t in all_types)
        self.type_list = [t for t in TYPE_ORDER if t in all_types]
        self.type_bits = tb = len(self.type_list) if len(self.type_list) > 1 else 0

        def onehot(types):
            return torch.tensor(
                [[1.0 if t == tt else 0.0 for tt in self.type_list[:tb]]
                 for t in types], dtype=torch.float32, device=dev,
            ).reshape(len(types), tb)

        self.a_type_oh, self.e_type_oh = onehot(ally_types), onehot(enemy_types)

        sh = 1 if self.has_shields else 0
        self._unit_feat = 5 + sh + tb
        self.obs_dim = (4 + E * self._unit_feat + (A - 1) * self._unit_feat
                        + 1 + sh + tb)
        self.state_dim = A * (4 + sh + tb) + E * (3 + sh + tb) + A * self.n_actions
        max_return = float(torch.sum(self.e_max_hp + self.e_max_sh).cpu()
                           + E * REWARD_KILL) + REWARD_WIN
        self.reward_scale = REWARD_SCALE / max_return

        center_y = MAP_SIZE / 2.0
        ar = torch.arange(A, device=dev, dtype=torch.int32)
        er = torch.arange(E, device=dev, dtype=torch.int32)
        self._ally_base = torch.stack(
            [torch.full((A,), 9.0, device=dev),
             center_y + (ar - (A - 1) / 2.0) * 1.5], dim=-1)
        self._enemy_base = torch.stack(
            [torch.full((E,), 23.0, device=dev),
             center_y + (er - (E - 1) / 2.0) * 1.5], dim=-1)
        # ally order with self removed: row i lists the other agents
        # ascending (jnp.delete in the JAX module)
        self._others = torch.tensor(
            [[j for j in range(A) if j != i] for i in range(A)],
            dtype=torch.int64, device=dev,
        ).reshape(A, A - 1)
        self._not_self = ~torch.eye(A, dtype=torch.bool, device=dev)
        self._not_self_units = ~torch.eye(A + E, dtype=torch.bool, device=dev)
        self._center = torch.tensor([MAP_SIZE / 2.0, MAP_SIZE / 2.0], device=dev)
        self._spawn_dest = torch.tensor([9.0, MAP_SIZE / 2.0], device=dev)

    # ------------------------------------------------------------------
    def _reset(self, num_envs: int, generator):
        A, E, dev = self.n_agents, self.n_enemies, self.device
        ja = torch.rand((num_envs, A, 2), generator=generator, device=dev) * 2.0 - 1.0
        je = torch.rand((num_envs, E, 2), generator=generator, device=dev) * 2.0 - 1.0
        zf = torch.zeros((num_envs,), device=dev)
        fb = torch.zeros((num_envs,), dtype=torch.bool, device=dev)
        s = SmacState(
            ally_pos=self._ally_base + ja,
            ally_hp=self.a_max_hp.expand(num_envs, A).clone(),
            ally_shield=self.a_max_sh.expand(num_envs, A).clone(),
            ally_cd=torch.zeros((num_envs, A), device=dev),
            enemy_pos=self._enemy_base + je,
            enemy_hp=self.e_max_hp.expand(num_envs, E).clone(),
            enemy_shield=self.e_max_sh.expand(num_envs, E).clone(),
            enemy_cd=torch.zeros((num_envs, E), device=dev),
            enemy_target=torch.full((num_envs, E), -1, dtype=torch.int64, device=dev),
            last_action=torch.zeros((num_envs, A), dtype=torch.int64, device=dev),
            t=torch.zeros((num_envs,), dtype=torch.int64, device=dev),
        )
        return s, self._timestep(s, zf, fb, fb, zf)

    # ------------------------------------------------------------------
    def _avail(self, s: SmacState) -> torch.Tensor:
        alive = s.ally_hp > 0.0                                       # (N,A)
        enemy_alive = s.enemy_hp > 0.0                                # (N,E)
        noop = (~alive)[..., None]
        stop = alive[..., None]
        cand = (s.ally_pos[:, :, None, :]
                + self.move_dirs[None, None] * self.a_move[None, :, None, None])
        in_bounds = ((cand >= 0.5) & (cand <= MAP_SIZE - 0.5)).all(-1)
        moves = in_bounds & alive[..., None]                          # (N,A,4)
        dist = _norm(s.ally_pos[:, :, None, :] - s.enemy_pos[:, None, :, :])
        attacks = ((dist <= ORDER_RANGE) & enemy_alive[:, None, :]
                   & alive[:, :, None])                               # (N,A,E)
        n_tgt = self.n_actions - N_FIXED_ACTIONS
        if self.ally_heals:
            attacks = attacks & (~self.a_heal)[None, :, None]
            dist_aa = _norm(s.ally_pos[:, :, None, :] - s.ally_pos[:, None, :, :])
            heals = ((dist_aa <= ORDER_RANGE) & alive[:, None, :] & alive[:, :, None]
                     & self.a_heal[None, :, None] & (~self.a_heal)[None, None, :]
                     & self._not_self[None])
            n, A = alive.shape

            def pad(x, k):
                return torch.cat([x, x.new_zeros((n, A, k))], dim=-1)

            attacks = pad(attacks, n_tgt - self.n_enemies) | pad(heals, n_tgt - A)
        return torch.cat([noop, stop, moves, attacks], dim=-1)

    # ------------------------------------------------------------------
    def _unit_obs_feats(self, vis, dist, delta, hp, max_hp, shield, max_sh, type_oh):
        feats = [
            torch.where(vis, dist / SIGHT_RANGE, 0.0)[..., None],
            torch.where(vis[..., None], delta / SIGHT_RANGE, 0.0),
            torch.where(vis, hp / max_hp, 0.0)[..., None],
        ]
        if self.has_shields:
            sh_pct = torch.where(max_sh > 0, shield / torch.clamp(max_sh, min=1.0), 0.0)
            feats.append(torch.where(vis, sh_pct, 0.0)[..., None])
        if self.type_bits:
            feats.append(torch.where(
                vis[..., None], type_oh.expand(vis.shape + (self.type_bits,)), 0.0))
        return torch.cat(feats, dim=-1)

    def _obs(self, s: SmacState, avail=None) -> torch.Tensor:
        n, A = s.ally_hp.shape
        alive = s.ally_hp > 0.0
        enemy_alive = s.enemy_hp > 0.0
        if avail is None:
            avail = self._avail(s)
        move_feats = avail[..., 2:6].float()                          # (N,A,4)

        delta_e = s.enemy_pos[:, None, :, :] - s.ally_pos[:, :, None, :]
        dist_e = _norm(delta_e)                                       # (N,A,E)
        vis_e = (dist_e <= SIGHT_RANGE) & enemy_alive[:, None, :]
        atk = (dist_e <= ORDER_RANGE) & enemy_alive[:, None, :] & alive[:, :, None]
        if self.ally_heals:
            atk = atk & (~self.a_heal)[None, :, None]
        enemy_feats = torch.cat(
            [atk.float()[..., None],
             self._unit_obs_feats(
                 vis_e, dist_e, delta_e,
                 s.enemy_hp[:, None, :], self.e_max_hp[None, None, :],
                 s.enemy_shield[:, None, :], self.e_max_sh[None, None, :],
                 self.e_type_oh[None, None])],
            dim=-1,
        ).reshape(n, A, -1)

        delta_a = s.ally_pos[:, None, :, :] - s.ally_pos[:, :, None, :]
        dist_a = _norm(delta_a)                                       # (N,A,A)
        vis_a = (dist_a <= SIGHT_RANGE) & alive[:, None, :]
        ally_full = torch.cat(
            [vis_a.float()[..., None],
             self._unit_obs_feats(
                 vis_a, dist_a, delta_a,
                 s.ally_hp[:, None, :], self.a_max_hp[None, None, :],
                 s.ally_shield[:, None, :], self.a_max_sh[None, None, :],
                 self.a_type_oh[None, None])],
            dim=-1,
        )                                                             # (N,A,A,f)
        rows = torch.arange(A, device=self.device)[:, None]
        ally_feats = ally_full[:, rows, self._others].reshape(n, A, -1)

        own = [(s.ally_hp / self.a_max_hp)[..., None]]
        if self.has_shields:
            own.append(torch.where(
                self.a_max_sh > 0,
                s.ally_shield / torch.clamp(self.a_max_sh, min=1.0), 0.0)[..., None])
        if self.type_bits:
            own.append(self.a_type_oh.expand(n, A, self.type_bits))
        obs = torch.cat([move_feats, enemy_feats, ally_feats] + own, dim=-1)
        return torch.where(alive[..., None], obs, 0.0)

    # ------------------------------------------------------------------
    def _state(self, s: SmacState) -> torch.Tensor:
        n, A = s.ally_hp.shape
        E = self.n_enemies
        half = MAP_SIZE / 2.0
        ally = [(s.ally_hp / self.a_max_hp)[..., None],
                (s.ally_cd / self.a_cd)[..., None],
                (s.ally_pos - self._center) / half]
        enemy = [(s.enemy_hp / self.e_max_hp)[..., None],
                 (s.enemy_pos - self._center) / half]
        if self.has_shields:
            ally.append(torch.where(
                self.a_max_sh > 0,
                s.ally_shield / torch.clamp(self.a_max_sh, min=1.0), 0.0)[..., None])
            enemy.append(torch.where(
                self.e_max_sh > 0,
                s.enemy_shield / torch.clamp(self.e_max_sh, min=1.0), 0.0)[..., None])
        if self.type_bits:
            ally.append(self.a_type_oh.expand(n, A, self.type_bits))
            enemy.append(self.e_type_oh.expand(n, E, self.type_bits))
        last = torch.nn.functional.one_hot(s.last_action, self.n_actions).float()
        return torch.cat([torch.cat(ally, -1).reshape(n, -1),
                          torch.cat(enemy, -1).reshape(n, -1),
                          last.reshape(n, -1)], dim=-1)

    def _timestep(self, s, reward, done, truncated, won):
        avail = self._avail(s)
        return TimeStep(obs=self._obs(s, avail), state=self._state(s),
                        avail=avail, reward=reward, done=done,
                        truncated=truncated, info={"battle_won": won})

    # ------------------------------------------------------------------
    @staticmethod
    def _apply_damage(hp, shield, dmg):
        """Shields absorb first; returns (hp', shield', total damage)."""
        absorbed = torch.minimum(shield, dmg)
        shield2 = shield - absorbed
        spill = dmg - absorbed
        hp2 = torch.clamp(hp - spill, min=0.0)
        dealt = (shield - shield2) + (hp - hp2)
        return hp2, shield2, dealt

    def _resolve_collisions(self, ally_pos, enemy_pos, ally_alive, enemy_alive):
        """Pairwise push-out so live units keep 2·UNIT_RADIUS apart: two
        Jacobi passes over the (N, A+E) units in which every overlapping
        live pair moves each member half the overlap apart, clipped to the
        map. Dead units neither push nor get pushed."""
        pos = torch.cat([ally_pos, enemy_pos], dim=1)                 # (N,U,2)
        live = torch.cat([ally_alive, enemy_alive], dim=1)            # (N,U)
        pair = live[:, :, None] & live[:, None, :] & self._not_self_units
        for _ in range(2):
            delta = pos[:, :, None, :] - pos[:, None, :, :]           # (N,U,U,2)
            dist = _norm(delta)
            overlap = torch.clamp(2.0 * UNIT_RADIUS - dist, min=0.0) * pair
            dirn = delta / torch.clamp(dist, min=1e-6)[..., None]
            pos = torch.clamp(pos + torch.sum(dirn * (0.5 * overlap)[..., None], dim=2),
                              0.5, MAP_SIZE - 0.5)
        return pos[:, :self.n_agents], pos[:, self.n_agents:]

    def _step(self, s: SmacState, actions, generator):
        A, E = self.n_agents, self.n_enemies
        alive = s.ally_hp > 0.0
        actions = torch.where(alive, actions.long(), 0)

        # ---- ally movement (explicit moves + attack-move) --------------
        is_move = (actions >= 2) & (actions < N_FIXED_ACTIONS)
        dir_idx = torch.clamp(actions - 2, 0, 3)
        step_vec = (self.move_dirs[dir_idx] * self.a_move[None, :, None]
                    * is_move[..., None])
        is_attack = actions >= N_FIXED_ACTIONS
        t_e = torch.clamp(actions - N_FIXED_ACTIONS, 0, E - 1)
        if self.ally_heals:
            t_a = torch.clamp(actions - N_FIXED_ACTIONS, 0, A - 1)
            tgt_pos = torch.where(self.a_heal[None, :, None],
                                  _take(s.ally_pos, t_a), _take(s.enemy_pos, t_e))
            tgt_alive = torch.where(self.a_heal[None],
                                    _take(s.ally_hp, t_a) > 0.0,
                                    _take(s.enemy_hp, t_e) > 0.0)
        else:
            tgt_pos = _take(s.enemy_pos, t_e)
            tgt_alive = _take(s.enemy_hp, t_e) > 0.0
        to_tgt = tgt_pos - s.ally_pos
        tgt_dist = _norm(to_tgt)
        out_of_range = tgt_dist > self.a_rng
        approach = ((is_attack & out_of_range & alive)[..., None] * to_tgt
                    / torch.clamp(tgt_dist, min=1e-6)[..., None]
                    * self.a_move[None, :, None])
        ally_pos = torch.clamp(s.ally_pos + step_vec + approach, 0.5, MAP_SIZE - 0.5)

        # ---- ally attacks / heals ---------------------------------------
        dist_after = _norm(ally_pos - tgt_pos)
        can_fire = (is_attack & alive & (s.ally_cd <= 0.0)
                    & (dist_after <= self.a_rng) & tgt_alive)
        atk_fire = can_fire
        if self.ally_heals:
            atk_fire = can_fire & ~self.a_heal
            heal_out = _scatter_add(
                A, t_a, torch.where(can_fire & self.a_heal, self.a_dmg, 0.0))
        dmg_out = _scatter_add(E, t_e, torch.where(atk_fire, self.a_dmg, 0.0))
        ally_cd = torch.where(can_fire, self.a_cd,
                              torch.clamp(s.ally_cd - 1.0, min=0.0))
        enemy_hp, enemy_shield, dealt = self._apply_damage(
            s.enemy_hp, s.enemy_shield, dmg_out)
        damage_dealt = dealt.sum(-1)
        kills = ((s.enemy_hp > 0.0) & (enemy_hp <= 0.0)).float().sum(-1)
        enemy_shield = torch.where(
            (dmg_out <= 0.0) & (enemy_hp > 0.0),
            torch.minimum(enemy_shield + SHIELD_REGEN, self.e_max_sh), enemy_shield)

        # ---- scripted enemy team: SC2-style attack-move ----------------
        enemy_alive2 = enemy_hp > 0.0
        dist_ea = _norm(s.enemy_pos[:, :, None, :] - s.ally_pos[:, None, :, :])
        dist_masked = torch.where(alive[:, None, :], dist_ea, float("inf"))
        nearest_dist, nearest = torch.min(dist_masked, dim=-1)
        cur = torch.clamp(s.enemy_target, 0, A - 1)
        cur_dist = torch.gather(dist_ea, 2, cur[..., None])[..., 0]
        cur_valid = ((s.enemy_target >= 0) & torch.gather(alive, 1, cur)
                     & (cur_dist <= self.e_rng + PURSUE_MARGIN))
        near_valid = nearest_dist <= SIGHT_RANGE
        has_target = cur_valid | near_valid
        target_a = torch.where(cur_valid, cur, nearest)
        tgt_dist = torch.gather(dist_ea, 2, target_a[..., None])[..., 0]
        fire = (enemy_alive2 & has_target & (tgt_dist <= self.e_rng)
                & (s.enemy_cd <= 0.0))
        if self.enemy_heals:
            fire = fire & ~self.e_heal
        dmg_in = _scatter_add(A, target_a, torch.where(fire, self.e_dmg, 0.0))
        shooting = fire
        if self.enemy_heals:
            frac = enemy_hp / self.e_max_hp
            mate_ok = enemy_alive2 & ~self.e_heal
            damaged = mate_ok & (frac < 1.0)
            has_damaged = damaged.any(-1)
            most_damaged = torch.argmin(
                torch.where(damaged, frac, float("inf")), dim=-1)
            dist_ee = _norm(s.enemy_pos[:, :, None, :] - s.enemy_pos[:, None, :, :])
            nearest_mate = torch.argmin(
                torch.where(mate_ok[:, None, :], dist_ee, float("inf")), dim=-1)
            follow_tgt = torch.where(has_damaged[:, None], most_damaged[:, None],
                                     nearest_mate)
            follow_pos = _take(s.enemy_pos, follow_tgt)
            fdist = _norm(follow_pos - s.enemy_pos)
            heal_fire = (self.e_heal & enemy_alive2 & has_damaged[:, None]
                         & (fdist <= self.e_rng) & (s.enemy_cd <= 0.0))
            heal_in_e = _scatter_add(
                E, follow_tgt, torch.where(heal_fire, self.e_dmg, 0.0))
            enemy_hp = torch.where(
                enemy_hp > 0.0, torch.minimum(enemy_hp + heal_in_e, self.e_max_hp),
                enemy_hp)
            shooting = fire | heal_fire
        enemy_cd = torch.where(shooting, self.e_cd,
                               torch.clamp(s.enemy_cd - 1.0, min=0.0))
        dest = torch.where(has_target[..., None], _take(s.ally_pos, target_a),
                           self._spawn_dest)
        no_tgt_move = ~has_target
        move_tgt_dist = tgt_dist
        if self.enemy_heals:
            dest = torch.where(self.e_heal[None, :, None], follow_pos, dest)
            move_tgt_dist = torch.where(self.e_heal, fdist, tgt_dist)
            has_target = has_target | self.e_heal
            no_tgt_move = ~has_target
        to_dest = dest - s.enemy_pos
        norm = _norm(to_dest, keepdim=True) + 1e-8
        advance = enemy_alive2 & (
            (has_target & (move_tgt_dist > self.e_rng))
            | (no_tgt_move & (norm[..., 0] > self.e_move)))
        enemy_pos = torch.clamp(
            s.enemy_pos + to_dest / norm * self.e_move[None, :, None]
            * advance[..., None], 0.5, MAP_SIZE - 0.5)
        keep = enemy_alive2 & has_target
        if self.enemy_heals:
            keep = keep & ~self.e_heal
        enemy_target = torch.where(keep, target_a, -1)
        ally_hp, ally_shield, _ = self._apply_damage(s.ally_hp, s.ally_shield, dmg_in)
        if self.ally_heals:
            ally_hp = torch.where(
                ally_hp > 0.0, torch.minimum(ally_hp + heal_out, self.a_max_hp),
                ally_hp)
        ally_shield = torch.where(
            (dmg_in <= 0.0) & (ally_hp > 0.0),
            torch.minimum(ally_shield + SHIELD_REGEN, self.a_max_sh), ally_shield)

        if self.unit_collisions:
            ally_pos, enemy_pos = self._resolve_collisions(
                ally_pos, enemy_pos, ally_hp > 0.0, enemy_hp > 0.0)

        # ---- termination / reward -------------------------------------
        t2 = s.t + 1
        all_enemies_dead = (enemy_hp <= 0.0).all(-1)
        all_allies_dead = (ally_hp <= 0.0).all(-1)
        done = all_enemies_dead | all_allies_dead
        won = all_enemies_dead
        truncated = (t2 >= self.episode_limit) & ~done
        reward = (damage_dealt + REWARD_KILL * kills
                  + REWARD_WIN * won.float()) * self.reward_scale
        s2 = SmacState(
            ally_pos=ally_pos, ally_hp=ally_hp, ally_shield=ally_shield,
            ally_cd=ally_cd, enemy_pos=enemy_pos, enemy_hp=enemy_hp,
            enemy_shield=enemy_shield, enemy_cd=enemy_cd,
            enemy_target=enemy_target, last_action=actions, t=t2,
        )
        return s2, self._timestep(s2, reward, done, truncated, won.float())
