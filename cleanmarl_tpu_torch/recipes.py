"""The validation recipes: the port's own copy of the 27 learning
configurations the JAX package guards in ``scripts/validate_baselines.py``
(``CONFIGS``), as plain data, with the comments that explain each guard.

Each recipe names a family (``algo``: the module under ``algos/``, with
``recurrent_q`` for QMIX-RNN and VDN-RNN), the config kwargs of one
training run, the eval threshold its converged tail must reach, and the
eval metric it is read on (``eval/ep_reward`` where none is named). The
runner is ``validate.py``; ``tests/test_torch_validate.py`` holds this
copy equal to the script's, so the two cannot drift. The port keeps its
own copy rather than reading the script at run time, as it does for every
module it needs.
"""

# name -> (algo module, config kwargs, eval-reward threshold)
# Thresholds are "sensible converged return" bars: comfortably above a
# random policy, close to the converged value observed on these JAX env
# ports (the reference publishes no in-tree numbers — BASELINE.md).
RECIPES = {
    "vdn_spread": dict(
        algo="vdn",
        kwargs=dict(
            env_type="mpe", env_name="simple_spread_v3",
            num_envs=32, total_timesteps=2_000_000,
            buffer_size=100_000, batch_size=4,
            learning_starts=10_000, train_freq=1,
            exploration_fraction=0.1, hidden_dim=64,
            log_interval=200,
        ),
        threshold=-30.0,   # validated tail -18.5 (run 2); margin for seeds
    ),
    "qmix_spread": dict(
        algo="qmix",
        kwargs=dict(
            env_type="mpe", env_name="simple_spread_v3",
            num_envs=32, total_timesteps=2_000_000,
            buffer_size=5_000, batch_size=32,
            exploration_fraction=0.1, hidden_dim=64,
            log_interval=40,
        ),
        threshold=-30.0,   # validated tail -19.5 (run 2, post-stabilization)
    ),
    "ippo_lbf": dict(
        algo="ippo",
        kwargs=dict(
            env_type="lbf", env_name="Foraging-8x8-2p-3f-v3",
            num_envs=64, total_timesteps=2_000_000,
            learning_rate_actor=5e-4, learning_rate_critic=5e-4,
            entropy_coef=0.01, anneal_entropy=True, epochs=4,
            normalize_advantage=True, actor_hidden_dim=64,
            critic_hidden_dim=64, log_interval=4,
        ),
        threshold=0.75,  # validated tail 0.833; fraction of food, optimum 1.0
    ),
    "maddpg_sl": dict(
        algo="maddpg",
        kwargs=dict(
            env_type="mpe", env_name="simple_speaker_listener_v4",
            num_envs=32, total_timesteps=2_000_000,
            buffer_size=5_000, batch_size=32,
            actor_hidden_dim=64, critic_hidden_dim=128,
            log_interval=40,
        ),
        threshold=-15.0,  # round-5 seed study: tails -9.5 / -5.9 / -7.3
        # (seeds 1/2/3; r5/maddpg_sl_s{2,3}.jsonl) — the -18.3 the r4
        # VERDICT flagged was a stale r3-era artifact; the serviced
        # target clock (r4) closed the gap. Threshold = worst seed − ~6.
    ),
    "facmac_sl": dict(
        algo="facmac",
        kwargs=dict(
            env_type="mpe", env_name="simple_speaker_listener_v4",
            num_envs=32, total_timesteps=2_000_000,
            buffer_size=5_000, batch_size=32,
            actor_hidden_dim=64, critic_hidden_dim=128,
            log_interval=40,
        ),
        threshold=-30.0,
    ),
    # the reference's experimental coma_lbf.py config: per-agent rewards
    # (reward_aggr=None) + truncation bootstrap on LBF. COMA is the
    # weakest/least stable algorithm in the family (the reference labels
    # this file experimental, coma_lbf.py:1-5): at lr 5e-4 it peaks at
    # 0.47 then collapses to ~0.08; lr 1e-4 converges stably around
    # 0.35-0.40 (grids repro'd twice — entropy and exploration
    # changes do not rescue the 5e-4 collapse).
    # Round-3 18-config stabilizer grid (validation/sweep_coma_lbf.jsonl)
    # on that plateau: a wider (128) critic with faster critic lr (3e-4)
    # lifts the tail to 0.44 — adopted below; target-polyak rate, n-step
    # vs TD(λ) targets, return normalization, deeper/wider-still critics
    # and longer budgets are all flat or worse.
    # Round-4 hypothesis grid (GRID4, same jsonl) closed the remaining
    # levers: td_lambda 0.5/0.95 → tails 0.431/0.443 (λ-insensitive);
    # entropy 0.01 annealed → 0.442; extra critic epochs per rollout
    # HURT (2 epochs → 0.356, 4 → 0.346 — the critic overfits each
    # rollout's targets and the counterfactual baseline loses its
    # variance-reduction bite). FINAL NEGATIVE RESULT vs the 0.5 tail
    # bar: every tested knob saturates at ~0.44 (bests touch 0.53-0.58
    # transiently), so the gap to IPPO's 0.83 is the algorithm —
    # the per-agent counterfactual advantage Q(s,(a_i,a_-i)) − Σ_a' π
    # Q(s,(a',a_-i)) has high variance exactly on LBF's sparse
    # simultaneous-loading events, and the policy decays once entropy
    # support narrows. The reference itself labels coma_lbf
    # experimental (coma_lbf.py:1-5).
    # recurrent value decomposition on SMAC (reference flagship family
    # qmix_lstm.py @ 3m, defaults hidden 64 / lr 5e-4 / batch 32 episodes /
    # train_freq 1 episode / polyak 0.005 / eps 1→0.025 over 5%;
    # VERDICT r2 weak-5: this path was unit-tested but had no committed
    # learning curve on a real env)
    "qmix_rnn_3m": dict(
        algo="recurrent_q",
        kwargs=dict(
            env_type="smaclite", env_name="3m", mixing="qmix",
            num_envs=64, total_timesteps=2_000_000,
            buffer_size=5_000, batch_size=32, train_freq=1,
            learning_rate=5e-4, polyak=0.005, hidden_dim=64,
            exploration_fraction=0.05, end_e=0.025,
            max_updates_per_iter=8, log_interval=50,
        ),
        threshold=0.85,  # eval battle_won (tails 0.991/0.994/0.978, s1-3)
        metric="eval/battle_won",
    ),
    # recurrent VDN (vdn_lstm family) on the same map/recipe
    "vdn_rnn_3m": dict(
        algo="recurrent_q",
        kwargs=dict(
            env_type="smaclite", env_name="3m", mixing="vdn",
            num_envs=64, total_timesteps=2_000_000,
            buffer_size=5_000, batch_size=32, train_freq=1,
            learning_rate=5e-4, polyak=0.005, hidden_dim=64,
            exploration_fraction=0.05, end_e=0.025,
            max_updates_per_iter=8, log_interval=50,
        ),
        threshold=0.85,  # eval battle_won (validated tail 0.99, r3 run)
        metric="eval/battle_won",
    ),
    # recurrent IPPO (ippo_lstm family) on the FF-validated env
    "ippo_rnn_lbf": dict(
        algo="ippo",
        kwargs=dict(
            env_type="lbf", env_name="Foraging-8x8-2p-3f-v3",
            num_envs=64, total_timesteps=2_000_000, recurrent=True,
            learning_rate_actor=5e-4, learning_rate_critic=5e-4,
            entropy_coef=0.01, anneal_entropy=True, epochs=4,
            normalize_advantage=True, actor_hidden_dim=64,
            critic_hidden_dim=64, log_interval=4,
        ),
        threshold=0.7,   # FF ippo_lbf tail 0.833 (validated r3: 0.84)
    ),
    # recurrent COMA (coma_lstm family) on the improved coma_lbf recipe
    "coma_rnn_lbf": dict(
        algo="coma",
        kwargs=dict(
            env_type="lbf", env_name="Foraging-8x8-2p-3f-v3",
            num_envs=64, total_timesteps=2_000_000, recurrent=True,
            per_agent_rewards=True, bootstrap_truncation=False,
            entropy_coef=0.003, exploration_fraction=3000.0,
            learning_rate_actor=1e-4, learning_rate_critic=3e-4,
            anneal_lr=True,
            actor_hidden_dim=64, critic_hidden_dim=128,
            log_interval=4,
        ),
        threshold=0.3,   # FF improved recipe tails 0.44/0.40
    ),
    # store-once episode layout (qmix_memefficient.py parity flag)
    "qmix_spread_memeff": dict(
        algo="qmix",
        kwargs=dict(
            env_type="mpe", env_name="simple_spread_v3",
            num_envs=32, total_timesteps=2_000_000,
            buffer_size=5_000, batch_size=32, memefficient=True,
            exploration_fraction=0.1, hidden_dim=64,
            log_interval=40,
        ),
        threshold=-30.0,  # full-storage qmix_spread tail -19.5
    ),
    # sequence-chunk replay + burn-in (vdn_lstm.py storage model)
    "vdn_rnn_seq_3m": dict(
        algo="recurrent_q",
        kwargs=dict(
            env_type="smaclite", env_name="3m", mixing="vdn",
            replay="sequence", seq_length=10, burn_in=8,
            num_envs=64, total_timesteps=2_000_000,
            buffer_size=20_000, batch_size=32, train_freq=1,
            learning_rate=5e-4, polyak=0.005, hidden_dim=64,
            exploration_fraction=0.05, end_e=0.025, log_interval=50,
        ),
        threshold=0.75,  # validated tail 0.919 (r3); below full-episode's 0.97
        metric="eval/battle_won",
    ),
    # recurrent MADDPG (maddpg_lstm family) on the FF-validated env
    "maddpg_rnn_sl": dict(
        algo="maddpg",
        kwargs=dict(
            env_type="mpe", env_name="simple_speaker_listener_v4",
            num_envs=32, total_timesteps=2_000_000,
            buffer_size=5_000, batch_size=32, recurrent=True,
            actor_hidden_dim=64, critic_hidden_dim=128,
            log_interval=40,
        ),
        threshold=-30.0,  # FF maddpg_sl converges ~-18; margin for GRU
    ),
    # pure-JAX SISL pursuit (round 4; reference's suggested PZ scenario,
    # vdn.py:21). Random policy ≈ -46 team return (urgency -0.1/cycle
    # over 500 cycles minus occasional tags/catches); learning shortens
    # episodes by catching evaders and raises tag/catch income.
    "vdn_pursuit": dict(
        algo="vdn",
        kwargs=dict(
            env_type="pursuit", num_envs=32, total_timesteps=2_000_000,
            buffer_size=100_000, batch_size=4, learning_starts=10_000,
            train_freq=1, exploration_fraction=0.1, hidden_dim=64,
            log_interval=200,
        ),
        threshold=-5.0,  # validated r4: tail_mean +3.52 team return
        # (best 11.1) vs random ≈ -46; margin for seed variance
    ),
    # PPO family on the same pure-JAX pursuit (on-policy coverage of
    # the round-4 env; truncated rollouts over the 500-cycle episodes)
    "ippo_pursuit": dict(
        algo="ippo",
        kwargs=dict(
            env_type="pursuit", num_envs=64, total_timesteps=2_000_000,
            rollout_len=100, epochs=4, entropy_coef=0.01,
            anneal_entropy=True, normalize_advantage=True,
            learning_rate_actor=5e-4, learning_rate_critic=5e-4,
            actor_hidden_dim=64, critic_hidden_dim=64, log_interval=2,
        ),
        threshold=5.0,  # validated r4: tail_mean +12.6 (best 14.6)
        # vs random ≈ -46; on-policy beats VDN's +3.5 here
    ),
    # the round-4 hard-map breakthrough as a regression guard: the
    # MAPPO-paper recipe (clip 0.05, 10 epochs, constant schedules,
    # death_masking + normalize_values) on 5m_vs_6m. The 100M curves
    # pass 0.95 by ~6M steps and sit at ~0.9+ by 20M (ENVS_FIDELITY
    # §3b grid); threshold leaves seed margin.
    "mappo_5m6m_paper": dict(
        algo="mappo",
        kwargs=dict(
            env_type="smaclite", env_name="5m_vs_6m", recurrent=True,
            num_envs=256, rollout_len=60, total_timesteps=20_000_000,
            actor_hidden_dim=128, critic_hidden_dim=128,
            learning_rate_actor=5e-4, learning_rate_critic=5e-4,
            entropy_coef=0.01, epochs=10, td_lambda=0.95, ppo_clip=0.05,
            normalize_advantage=True, death_masking=True,
            normalize_values=True, log_interval=4,
        ),
        threshold=0.6,
        metric="eval/battle_won",
    ),
    # round-5 combat-map validation for the three families whose
    # reference configs default to SMAClite (coma.py:20-22 /
    # facmac.py:20-22 / maddpg.py:19-21) — recipes = the winning cells
    # of validation/sweep_combat_r5.jsonl (curves in validation/r5/)
    "coma_3m": dict(
        algo="coma",
        kwargs=dict(
            env_type="smaclite", env_name="3m",
            num_envs=64, total_timesteps=2_000_000,
            actor_hidden_dim=64, critic_hidden_dim=128,
            learning_rate_actor=5e-4, learning_rate_critic=5e-4,
            td_lambda=0.8, normalize_advantage=True,
            entropy_coef=0.001, start_e=0.5, end_e=0.002,
            exploration_fraction=100.0, log_interval=8,
        ),
        threshold=0.5,   # validated tail 0.80 (best 0.92); COMA is the
        metric="eval/battle_won",  # family's high-variance member
    ),
    "facmac_3m": dict(
        algo="facmac",
        kwargs=dict(
            env_type="smaclite", env_name="3m",
            num_envs=64, total_timesteps=2_000_000,
            buffer_size=5_000, batch_size=64, train_freq=1,
            learning_rate_actor=5e-4, learning_rate_critic=5e-4,
            actor_hidden_dim=64, critic_hidden_dim=64, hyper_dim=64,
            polyak=0.005, exploration_fraction=750.0,
            max_updates_per_iter=8, log_interval=50,
        ),
        threshold=0.75,  # validated tail 0.95 (ref-default batch 10→
        metric="eval/battle_won",  # 32-shaped recipe: 0.88)
    ),
    "maddpg_3m": dict(
        algo="maddpg",
        kwargs=dict(
            env_type="smaclite", env_name="3m",
            num_envs=64, total_timesteps=2_000_000,
            buffer_size=5_000, batch_size=32, train_freq=1,
            learning_rate_actor=3e-4, learning_rate_critic=3e-4,
            actor_hidden_dim=64, critic_hidden_dim=128,
            normalize_reward=True,
            max_updates_per_iter=8, log_interval=50,
        ),
        threshold=0.6,   # validated FF tail 0.89; the GRU variant
        metric="eval/battle_won",  # reaches 0.95 (maddpg_3m_rnn)
    ),
    # round-5 guards for the round-4 breakthroughs (VERDICT r4 next-3).
    # Budgets are truncations of the committed 50M curves at the point
    # the run is decisively past threshold, to keep --all affordable:
    # 8m_vs_9m hit 1.0 by 3.4M steps (mappo_8m9m_r4.jsonl), 27m_vs_30m
    # 0.97 by 6.9M / 1.0 by 12.8M (mappo_27m30m_r4.jsonl).
    "mappo_8m9m_paper": dict(
        algo="mappo",
        kwargs=dict(
            env_type="smaclite", env_name="8m_vs_9m", recurrent=True,
            num_envs=256, rollout_len=60, total_timesteps=10_000_000,
            actor_hidden_dim=128, critic_hidden_dim=128,
            learning_rate_actor=5e-4, learning_rate_critic=5e-4,
            entropy_coef=0.01, epochs=10, td_lambda=0.95, ppo_clip=0.05,
            normalize_advantage=True, death_masking=True,
            normalize_values=True, log_interval=4,
        ),
        threshold=0.8,   # r4 curve: 0.9-1.0 throughout 4-10M
        metric="eval/battle_won",
    ),
    "mappo_27m30m_paper": dict(
        algo="mappo",
        kwargs=dict(
            env_type="smaclite", env_name="27m_vs_30m", recurrent=True,
            num_envs=512, rollout_len=60, total_timesteps=15_000_000,
            actor_hidden_dim=128, critic_hidden_dim=128,
            learning_rate_actor=5e-4, learning_rate_critic=5e-4,
            entropy_coef=0.01, epochs=10, td_lambda=0.95, ppo_clip=0.05,
            normalize_advantage=True, death_masking=True,
            normalize_values=True, log_interval=4,
        ),
        threshold=0.75,  # r4 curve: ≥0.97 from 6.9M on
        metric="eval/battle_won",
    ),
    # Heterogeneous maps under per-type movement speeds (round 5 —
    # ENVS_FIDELITY S3 closed; curves validation/r5/mappo_*_speed.jsonl,
    # annealed north-star recipe). Budgets trimmed to where each curve
    # is already converged; thresholds = tail minus seed margin.
    "mappo_mmm": dict(
        algo="mappo",
        kwargs=dict(
            env_type="smaclite", env_name="MMM", recurrent=True,
            num_envs=256, rollout_len=60, total_timesteps=10_000_000,
            actor_hidden_dim=128, critic_hidden_dim=128,
            learning_rate_actor=5e-4, learning_rate_critic=5e-4,
            entropy_coef=0.01, anneal_entropy=True, anneal_lr=True,
            epochs=8, td_lambda=0.95, normalize_advantage=True,
            log_interval=4,
        ),
        threshold=0.75,  # r5 speed curve: 1.0 from 4.4M on (tail10 0.988)
        metric="eval/battle_won",
    ),
    "mappo_mmm2": dict(
        algo="mappo",
        kwargs=dict(
            env_type="smaclite", env_name="MMM2", recurrent=True,
            num_envs=256, rollout_len=60, total_timesteps=15_000_000,
            actor_hidden_dim=128, critic_hidden_dim=128,
            learning_rate_actor=5e-4, learning_rate_critic=5e-4,
            entropy_coef=0.01, anneal_entropy=True, anneal_lr=True,
            epochs=8, td_lambda=0.95, normalize_advantage=True,
            log_interval=4,
        ),
        threshold=0.75,  # r5 speed curve: ~1.0 from 12M on (tail10 0.997)
        metric="eval/battle_won",
    ),
    "mappo_2s3z": dict(
        algo="mappo",
        kwargs=dict(
            env_type="smaclite", env_name="2s3z", recurrent=True,
            num_envs=256, rollout_len=60, total_timesteps=40_000_000,
            actor_hidden_dim=128, critic_hidden_dim=128,
            learning_rate_actor=5e-4, learning_rate_critic=5e-4,
            entropy_coef=0.01, anneal_entropy=True, anneal_lr=True,
            epochs=8, td_lambda=0.95, normalize_advantage=True,
            log_interval=4,
        ),
        threshold=0.65,  # r5 speed curve tail10 0.834 (oscillates 0.62-0.94)
        metric="eval/battle_won",
    ),
    # 3s5z: the winning round-5 recipe is annealed + the hard-map levers
    # (death_masking/normalize_values) — tail10 0.856 under per-type
    # speeds vs 0.60-0.66 for the paper/plain recipes
    "mappo_3s5z": dict(
        algo="mappo",
        kwargs=dict(
            env_type="smaclite", env_name="3s5z", recurrent=True,
            num_envs=256, rollout_len=60, total_timesteps=40_000_000,
            actor_hidden_dim=128, critic_hidden_dim=128,
            learning_rate_actor=5e-4, learning_rate_critic=5e-4,
            entropy_coef=0.01, anneal_entropy=True, anneal_lr=True,
            epochs=8, td_lambda=0.95, normalize_advantage=True,
            death_masking=True, normalize_values=True,
            log_interval=4,
        ),
        threshold=0.65,  # r5 lever_speed curve tail10 0.856
        metric="eval/battle_won",
    ),
    # QMIX-RNN cracks 5m_vs_6m with its unchanged 3m recipe (round 4,
    # qmix_rnn_5m6m_r4.jsonl: 0 until ~5M, 0.95 tail at 10M) — the full
    # budget is required; the threshold leaves seed margin on the tail
    "qmix_rnn_5m6m": dict(
        algo="recurrent_q",
        kwargs=dict(
            env_type="smaclite", env_name="5m_vs_6m", mixing="qmix",
            num_envs=64, total_timesteps=10_000_000,
            buffer_size=5_000, batch_size=32, train_freq=1,
            learning_rate=5e-4, polyak=0.005, hidden_dim=64,
            exploration_fraction=0.05, end_e=0.025,
            max_updates_per_iter=8, log_interval=50,
        ),
        threshold=0.6,   # r4 tail 0.95-0.97
        metric="eval/battle_won",
    ),
    # round-5 MPE addition: the referential game (both-ways speaker/
    # listener, Discrete(50) move x comm). Curve r5/mappo_reference.jsonl:
    # random -40 -> tail5 -14.4 at 2M steps (consistent with the
    # MADDPG-paper-era results on cooperative communication)
    "mappo_reference": dict(
        algo="mappo",
        kwargs=dict(
            env_type="mpe", env_name="simple_reference_v3",
            num_envs=64, total_timesteps=2_000_000,
            learning_rate_actor=5e-4, learning_rate_critic=5e-4,
            entropy_coef=0.01, anneal_entropy=True, epochs=4,
            normalize_advantage=True, log_interval=8,
        ),
        threshold=-20.0,  # validated tail5 -14.4; random -40
    ),
    "coma_lbf": dict(
        algo="coma",
        kwargs=dict(
            env_type="lbf", env_name="Foraging-8x8-2p-3f-v3",
            num_envs=64, total_timesteps=2_000_000,
            per_agent_rewards=True, bootstrap_truncation=True,
            entropy_coef=0.003, exploration_fraction=3000.0,
            learning_rate_actor=1e-4, learning_rate_critic=3e-4,
            anneal_lr=True,
            actor_hidden_dim=64, critic_hidden_dim=128,
            log_interval=4,
        ),
        threshold=0.38,  # improved-recipe tail 0.44; optimum 1.0
    ),
}
