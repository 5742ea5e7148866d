"""Flag-matrix smoke test of the port: every advertised config flag must
construct through ``cleanmarl_tpu_torch``'s ``make_train`` and run one
train block on the CPU.

The JAX package keeps the same matrix (``tests/test_flag_matrix.py``)
because ``--gru_impl pallas`` once shipped broken for the PPO family (an
UnboundLocalError inside ``make_train``) while every kernel test was
green: they called the GRU directly and no test built the config through
the factory. A flag that cannot run one block cannot ship, in the port
either.

Each case is (family, overrides) over the same matrix-game bases as the
JAX file. The assertion is executional (finite metrics, at least one
gradient update where the runner counts them); learning is covered by
the per-family tests and the validation recipes (``recipes.py``).

The coverage guard reads the port's config dataclasses: each field is an
advertised flag (which some case must set), a setting that is not a flag
of the matrix (sizes, rates, env choice, logging, checkpoints,
processes), or a field only the port has. A field in none of the three,
or in a list but not in the dataclass, fails.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cleanmarl_tpu_torch.algos import coma as m_coma
from cleanmarl_tpu_torch.algos import facmac as m_facmac
from cleanmarl_tpu_torch.algos import maddpg as m_maddpg
from cleanmarl_tpu_torch.algos import qmix as m_qmix
from cleanmarl_tpu_torch.algos import recurrent_q as m_recq
from cleanmarl_tpu_torch.algos import vdn as m_vdn
from cleanmarl_tpu_torch.algos.ippo import make_train as make_ippo
from cleanmarl_tpu_torch.algos.mappo import make_train as make_mappo
from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig
from cleanmarl_tpu_torch.envs.matrix_game import MatrixGame

torch.set_num_threads(1)


def tiny_env():
    return MatrixGame(n_agents=2, n_actions=3, episode_limit=8, device="cpu")


# --- per-family minimal bases (one short block each), as the JAX file ----

PPO_BASE = dict(env_type="matrix", num_envs=8, total_timesteps=512,
                epochs=2, log_interval=2, num_eval_ep=2, seed=0)
COMA_BASE = dict(env_type="matrix", num_envs=8, total_timesteps=512,
                 log_interval=2, num_eval_ep=2, seed=0)
VDN_BASE = dict(env_type="matrix", num_envs=8, buffer_size=512,
                total_timesteps=2000, learning_starts=64, train_freq=1,
                batch_size=8, log_interval=20, num_eval_ep=2, seed=0)
QMIX_BASE = dict(env_type="matrix", num_envs=8, buffer_size=128,
                 total_timesteps=2000, train_freq=1, batch_size=8,
                 hidden_dim=32, hyper_dim=16, embed_dim=8,
                 log_interval=20, num_eval_ep=2, seed=0)
RECQ_BASE = dict(env_type="matrix", num_envs=8, buffer_size=128,
                 total_timesteps=2000, train_freq=1, batch_size=8,
                 hidden_dim=32, hyper_dim=16, embed_dim=8,
                 log_interval=20, num_eval_ep=2, seed=0)
MADDPG_BASE = dict(env_type="matrix", num_envs=8, buffer_size=128,
                   total_timesteps=2000, train_freq=1, batch_size=8,
                   actor_hidden_dim=16, critic_hidden_dim=32,
                   log_interval=20, num_eval_ep=2, seed=0)
FACMAC_BASE = dict(env_type="matrix", num_envs=8, buffer_size=128,
                   total_timesteps=2000, train_freq=1, batch_size=8,
                   actor_hidden_dim=16, critic_hidden_dim=32,
                   hyper_dim=16, embed_dim=8,
                   log_interval=20, num_eval_ep=2, seed=0)

# Every advertised flag appears in at least one case below (the JAX
# file's 41 cases; ``pallas``/``xla`` are the port's aliases of its
# ``kernel``/``scan`` GRU routes, and on the CPU the kernel route runs
# the kernels' plain versions).
CASES = [
    # --- PPO family (ippo.py / mappo.py Args + §4b deviations) ---
    ("ippo", dict(recurrent=True, gru_impl="pallas")),       # the regression
    ("mappo", dict(recurrent=True, gru_impl="pallas")),
    # "auto" (the default) must resolve and run everywhere: on the CPU it
    # resolves to the scan, and with the kernels' unsupported modes it
    # must pick the scan rather than raise
    ("ippo", dict(recurrent=True, gru_impl="auto")),
    ("ippo", dict(recurrent=True, gru_impl="auto", tbptt=2)),
    ("mappo", dict(recurrent=True, gru_impl="auto",
                   compute_dtype="bfloat16")),
    ("ippo", dict(recurrent=True, compute_dtype="bfloat16")),
    ("mappo", dict(recurrent=True, compute_dtype="bfloat16",
                   num_minibatches=2)),
    ("ippo", dict(recurrent=True, remat_actor=True)),
    ("ippo", dict(recurrent=True, tbptt=4)),
    ("ippo", dict(num_minibatches=2)),
    ("mappo", dict(recurrent=True, num_minibatches=4, anneal_lr=True,
                   anneal_entropy=True)),
    ("ippo", dict(normalize_reward=True, normalize_advantage=True,
                  normalize_return=True)),
    ("ippo", dict(recurrent=True, rollout_len=6)),
    ("mappo", dict(recurrent=True, death_masking=True,
                   normalize_values=True)),
    ("ippo", dict(death_masking=True, normalize_values=True,
                  num_minibatches=2)),
    # --- COMA family (coma.py Args) ---
    ("coma", dict(recurrent=True)),
    ("coma", dict(use_tdlambda=False, nsteps=3)),
    ("coma", dict(bootstrap_truncation=True)),
    ("coma", dict(normalize_reward=True, normalize_return=True,
                  anneal_lr=True)),
    ("coma", dict(critic_epochs=3, anneal_entropy=True)),
    ("coma", dict(critic_epochs=4, anneal_lr=True)),
    # --- VDN family (vdn.py Args) ---
    ("vdn", dict(bootstrap_truncation=True)),
    ("vdn", dict(normalize_reward=True)),
    # --- QMIX family (qmix.py / qmix_memefficient.py Args) ---
    ("qmix", dict(memefficient=True)),
    ("qmix", dict(double_q=False)),
    ("qmix", dict(hard_target=True, target_network_update_freq=4)),
    ("qmix", dict(max_updates_per_iter=1)),
    ("qmix", dict(bootstrap_truncation=True, normalize_reward=True)),
    # --- recurrent-Q family (vdn_lstm.py / qmix_lstm.py Args) ---
    ("recq", dict(mixing="qmix")),
    ("recq", dict(replay="sequence", seq_length=6, burn_in=2)),
    ("recq", dict(tbptt=4)),
    ("recq", dict(compute_dtype="bfloat16")),
    ("recq", dict(gru_impl="pallas")),
    ("recq", dict(gru_impl="auto")),
    ("recq", dict(mixing="qmix", max_updates_per_iter=1)),
    ("recq", dict(bootstrap_truncation=True, normalize_reward=True)),
    # --- MADDPG family (maddpg.py / maddpg_lstm.py Args) ---
    ("maddpg", dict(recurrent=True)),
    ("maddpg", dict(max_updates_per_iter=1)),
    ("maddpg", dict(normalize_reward=False)),
    # --- FACMAC family (facmac.py Args) ---
    ("facmac", dict(max_updates_per_iter=1)),
    ("facmac", dict(normalize_reward=True)),
]

FAMILIES = {
    # name -> (factory, Config, base overrides)
    "ippo": (make_ippo, PPOConfig, PPO_BASE),
    "mappo": (make_mappo, PPOConfig, PPO_BASE),
    "coma": (m_coma.make_train, m_coma.COMAConfig, COMA_BASE),
    "vdn": (m_vdn.make_train, m_vdn.VDNConfig, VDN_BASE),
    "qmix": (m_qmix.make_train, m_qmix.QMIXConfig, QMIX_BASE),
    "recq": (m_recq.make_train, m_recq.RecurrentQConfig, RECQ_BASE),
    "maddpg": (m_maddpg.make_train, m_maddpg.MADDPGConfig, MADDPG_BASE),
    "facmac": (m_facmac.make_train, m_facmac.FACMACConfig, FACMAC_BASE),
}

# the flags the JAX file's guard lists (``ippo`` covers MAPPO's cases too)
ADVERTISED = {
    "ippo": ["recurrent", "tbptt", "gru_impl", "compute_dtype",
             "remat_actor", "num_minibatches", "anneal_lr",
             "anneal_entropy", "normalize_reward",
             "normalize_advantage", "normalize_return", "rollout_len",
             "death_masking", "normalize_values"],
    "coma": ["recurrent", "use_tdlambda", "nsteps",
             "bootstrap_truncation", "normalize_reward",
             "normalize_return", "anneal_lr", "critic_epochs",
             "anneal_entropy"],
    "vdn": ["bootstrap_truncation", "normalize_reward"],
    "qmix": ["memefficient", "double_q", "hard_target",
             "max_updates_per_iter", "bootstrap_truncation",
             "normalize_reward"],
    "recq": ["mixing", "replay", "seq_length", "burn_in", "tbptt",
             "compute_dtype", "gru_impl", "max_updates_per_iter",
             "bootstrap_truncation", "normalize_reward"],
    "maddpg": ["recurrent", "max_updates_per_iter",
               "normalize_reward"],
    "facmac": ["max_updates_per_iter", "normalize_reward"],
}

# settings every family shares that are not flags of the matrix: the env
# choice, the run's length and logging, checkpoints, profiling and the
# process group (each has its own tests: test_torch_checkpoint.py,
# test_torch_distributed*.py)
_RUN = ["env_type", "env_name", "env_family", "agent_ids", "num_envs",
        "total_timesteps", "gamma", "optimizer", "clip_gradients",
        "log_interval", "eval_steps", "num_eval_ep", "checkpoint_dir",
        "checkpoint_every", "resume", "use_wnb", "wnb_project",
        "wnb_entity", "profile_dir", "use_mesh", "coordinator_address",
        "num_processes", "process_id", "seed", "verbose"]
_OFFPOLICY = ["buffer_size", "batch_size", "train_freq", "polyak",
              "target_network_update_freq"]
_EPS = ["start_e", "end_e", "exploration_fraction"]
# sizes and rates of each family, also not flags of the matrix
NOT_FLAGS = {
    "ippo": _RUN + ["actor_hidden_dim", "critic_hidden_dim",
                    "actor_num_layers", "critic_num_layers", "learning_rate_actor",
                    "learning_rate_critic", "epochs", "entropy_coef", "ppo_clip",
                    "td_lambda"],
    "coma": _RUN + _EPS + ["rollout_len", "actor_hidden_dim", "critic_hidden_dim",
                           "actor_num_layers", "critic_num_layers",
                           "learning_rate_actor", "learning_rate_critic",
                           "entropy_coef", "td_lambda", "polyak",
                           "target_network_update_freq", "normalize_advantage",
                           "per_agent_rewards"],
    "vdn": _RUN + _OFFPOLICY + _EPS + ["hidden_dim", "num_layers", "learning_rate",
                                       "learning_starts"],
    "qmix": _RUN + _OFFPOLICY + _EPS + ["hidden_dim", "hyper_dim", "embed_dim",
                                        "num_layers", "learning_rate"],
    "recq": _RUN + _OFFPOLICY + _EPS + ["hidden_dim", "hyper_dim", "embed_dim",
                                        "learning_rate"],
    "maddpg": _RUN + _OFFPOLICY + ["actor_hidden_dim", "critic_hidden_dim",
                                   "actor_num_layers", "critic_num_layers",
                                   "learning_rate_actor", "learning_rate_critic",
                                   "gumbel_tau"],
    "facmac": _RUN + _OFFPOLICY + _EPS + ["actor_hidden_dim", "critic_hidden_dim",
                                          "actor_num_layers", "critic_num_layers",
                                          "learning_rate_actor", "learning_rate_critic",
                                          "gumbel_tau", "hyper_dim", "embed_dim"],
}

# fields only the port has: ``device`` (every entry point runs on the card
# unless asked; every case here passes "cpu"), and ``unit_collisions``
# (SMAClite's pairwise unit collisions, which the matrix game has not; its
# own tests are in test_torch_envs.py and test_torch_host_env.py)
PORT_ONLY = {fam: ["device"] for fam in ADVERTISED}
PORT_ONLY["ippo"] = ["device", "unit_collisions"]

CONFIG_OF = {"ippo": PPOConfig, "coma": m_coma.COMAConfig, "vdn": m_vdn.VDNConfig,
             "qmix": m_qmix.QMIXConfig, "recq": m_recq.RecurrentQConfig,
             "maddpg": m_maddpg.MADDPGConfig, "facmac": m_facmac.FACMACConfig}


def _case_id(case):
    fam, over = case
    return fam + "-" + "-".join(f"{k}={v}" for k, v in over.items())


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_flag_executes_one_block(case):
    fam, over = case
    factory, Config, base = FAMILIES[fam]
    cfg = Config(**{**base, **over}, device="cpu")
    out = factory(cfg, tiny_env())
    init, train_block = out[0], out[1]
    runner = init(torch.Generator().manual_seed(0))
    runner, metrics = train_block(runner)
    for k, v in metrics.items():
        arr = np.asarray(torch.as_tensor(v).detach().double())
        assert np.all(np.isfinite(arr)), (k, v)
    # where the runner counts updates, demand the flagged path actually
    # took a gradient step inside the block
    n_upd = getattr(runner, "num_updates", None)
    if n_upd is not None:
        assert int(n_upd) > 0, "block ran but no update executed"


def test_matrix_covers_every_advertised_flag():
    """The matrix itself is guarded against the port's configs: every
    advertised flag appears in at least one case, and every field of each
    family's config is an advertised flag, a listed non-flag setting or a
    listed port-only field, so a new field cannot slip past the matrix."""
    assert len(CASES) == 41
    for fam, flags in ADVERTISED.items():
        fams = {fam, "mappo"} if fam == "ippo" else {fam}
        covered = set()
        for f, over in CASES:
            if f in fams:
                covered.update(over)
        missing = set(flags) - covered
        assert not missing, (fam, sorted(missing))

        fields = {f.name for f in dataclasses.fields(CONFIG_OF[fam])}
        lists = (set(flags), set(NOT_FLAGS[fam]), set(PORT_ONLY[fam]))
        assert not (lists[0] & lists[1] or lists[0] & lists[2] or lists[1] & lists[2]), fam
        listed = set().union(*lists)
        assert not fields - listed, (fam, "fields in no list", sorted(fields - listed))
        assert not listed - fields, (fam, "listed but not fields", sorted(listed - fields))
