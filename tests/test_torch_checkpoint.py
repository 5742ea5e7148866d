"""Checkpoint and resume of the port (``core/checkpoint.py``), mirroring
``tests/test_checkpoint.py`` on the CPU.

- for each of the seven families (MAPPO, COMA, QMIX, VDN, recurrent Q with
  episode and with sequence replay, MADDPG, FACMAC), and MAPPO with
  ``rmsprop`` under the LR anneal: save after a block, restore into an
  init of another seed, and the next block is bit-identical (every tensor,
  generator state and host counter of the runner, and every metric);
- the QMIX episode ring and accumulator survive exactly;
- a resumed ``vdn.train`` trains only the remaining budget (512 → 1024 →
  1024 env steps), as the JAX driver's ``num_blocks`` rule does;
- ``max_to_keep`` pruning; a half-written step is ignored; a template of
  another shape, or of another optimizer (``adam`` saved, ``lamb``
  restored), raises naming the field (a restore at another world size,
  and the layouts it refuses, are in ``tests/test_torch_elastic_resume.py``);
- ``use_wnb`` reaches ``wandb.init`` through the port's ``Logger``.

The card's resume is checked by ``chip_smoke.py`` phase 9.
"""
import os
import sys
import types

import pytest
import torch

from cleanmarl_tpu_torch.algos import (
    coma, facmac, maddpg, ppo_common, qmix, recurrent_q, vdn,
)
from cleanmarl_tpu_torch.core.checkpoint import Checkpointer, to_state
from cleanmarl_tpu_torch.core.driver import to_host
from cleanmarl_tpu_torch.core.params import tree_leaves
from cleanmarl_tpu_torch.distributed import dp
from cleanmarl_tpu_torch.envs.matrix_game import MatrixGame

torch.set_num_threads(1)

_SL = dict(env_type="mpe", env_name="simple_speaker_listener_v4", num_envs=4,
           buffer_size=10, batch_size=4, log_interval=25, actor_hidden_dim=8,
           critic_hidden_dim=8, num_eval_ep=2, seed=0, verbose=False)
_RQ = dict(env_type="matrix", num_envs=4, buffer_size=16, batch_size=4, log_interval=8,
           hidden_dim=8, hyper_dim=8, embed_dim=4, seq_length=4, burn_in=2,
           num_eval_ep=2, seed=0, verbose=False)
FAMILIES = {
    "mappo": (lambda c: ppo_common.make_train(c, centralized=True), ppo_common.PPOConfig,
              dict(env_type="smaclite", env_name="3m", recurrent=True, num_envs=4,
                   rollout_len=10, actor_hidden_dim=8, critic_hidden_dim=8, epochs=2,
                   num_minibatches=2, log_interval=1, normalize_values=True, seed=0,
                   verbose=False)),
    "mappo_rmsprop": (lambda c: ppo_common.make_train(c, centralized=True),
                      ppo_common.PPOConfig,
                      dict(env_type="smaclite", env_name="3m", recurrent=True, num_envs=4,
                           rollout_len=10, actor_hidden_dim=8, critic_hidden_dim=8,
                           epochs=2, num_minibatches=2, log_interval=1, optimizer="rmsprop",
                           anneal_lr=True, total_timesteps=400, seed=0, verbose=False)),
    "coma": (coma.make_train, coma.COMAConfig,
             dict(env_type="matrix", num_envs=4, log_interval=2, actor_hidden_dim=8,
                  critic_hidden_dim=8, recurrent=True, seed=0, verbose=False)),
    "qmix": (qmix.make_train, qmix.QMIXConfig,
             dict(env_type="mpe", env_name="simple_spread_v3", num_envs=4, buffer_size=10,
                  batch_size=4, log_interval=25, hidden_dim=8, hyper_dim=8, embed_dim=4,
                  max_updates_per_iter=2, seed=0, verbose=False)),
    "vdn": (vdn.make_train, vdn.VDNConfig,
            dict(env_type="mpe", env_name="simple_spread_v3", num_envs=4, buffer_size=200,
                 batch_size=4, learning_starts=40, train_freq=2, log_interval=30,
                 hidden_dim=8, seed=0, verbose=False)),
    "recurrent_q_episode": (recurrent_q.make_train, recurrent_q.RecurrentQConfig,
                            dict(_RQ, mixing="qmix", max_updates_per_iter=2)),
    "recurrent_q_sequence": (recurrent_q.make_train, recurrent_q.RecurrentQConfig,
                             dict(_RQ, mixing="vdn", replay="sequence")),
    "maddpg": (maddpg.make_train, maddpg.MADDPGConfig, dict(_SL, recurrent=True)),
    "facmac": (facmac.make_train, facmac.FACMACConfig,
               dict(_SL, hyper_dim=8, embed_dim=4)),
}
# each family's table of per-env fields (dp.DATA_FIELD_DIMS)
TABLES = {"mappo": "PPO", "mappo_rmsprop": "PPO", "coma": "COMA", "qmix": "QMIX", "vdn": "VDN",
          "recurrent_q_episode": "RECURRENT_Q", "recurrent_q_sequence": "RECURRENT_Q",
          "maddpg": "MADDPG", "facmac": "FACMAC"}


def _checkpointer(path, family, **kw):
    return Checkpointer(str(path), field_dims=dp.DATA_FIELD_DIMS[TABLES[family]],
                        seed=FAMILIES[family][2]["seed"], **kw)


def _flat(tree, path="runner"):
    """(path, value) of every leaf of ``to_state(tree)``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f"{path}.{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _flat(v, f"{path}[{i}]")]
    return [(path, tree)]


def assert_identical(a, b):
    fa, fb = _flat(to_state(a)), _flat(to_state(b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert type(x) is type(y) and x == y, path


def _block(train_block, runner):
    runner, metrics = train_block(runner)
    return runner, to_host(metrics)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_resume_is_bit_exact(family, tmp_path):
    make_train, config, kw = FAMILIES[family]
    init, train_block, _, _ = make_train(config(**kw, device="cpu"))
    runner, _ = _block(train_block, init(torch.Generator().manual_seed(0)))
    ckpt = _checkpointer(tmp_path, family)
    step = runner.step
    ckpt.save(step, runner, wait=True)
    assert ckpt.latest_step() == step
    assert (tmp_path / str(step) / "rank0.pt").exists()

    restored = ckpt.restore(init(torch.Generator().manual_seed(42)))
    assert_identical(restored, runner)
    a, ma = _block(train_block, runner)
    b, mb = _block(train_block, restored)
    assert ma == mb
    assert_identical(a, b)
    ckpt.close()


def test_qmix_ring_and_accumulator_survive_exactly(tmp_path):
    _, _, kw = FAMILIES["qmix"]
    init, train_block, _, _ = qmix.make_train(qmix.QMIXConfig(**kw, device="cpu"))
    runner, _ = _block(train_block, init(torch.Generator().manual_seed(0)))
    assert runner.ring.size > 0 and runner.update_debt > 0
    ckpt = _checkpointer(tmp_path, "qmix")
    ckpt.save(runner.step, runner)
    restored = ckpt.restore(init(torch.Generator().manual_seed(9)))
    for a, b in zip(tree_leaves(restored.ring.data), tree_leaves(runner.ring.data)):
        assert torch.equal(a, b)
    assert torch.equal(restored.ring.length, runner.ring.length)
    assert (restored.ring.cursor, restored.ring.size) == (runner.ring.cursor,
                                                          runner.ring.size)
    assert torch.equal(restored.acc.t, runner.acc.t)
    for a, b in zip(tree_leaves(restored.acc.store), tree_leaves(runner.acc.store)):
        assert torch.equal(a, b)
    assert (restored.update_debt, restored.episodes) == (runner.update_debt,
                                                         runner.episodes)


def test_resume_trains_only_remaining_budget(tmp_path):
    """A resumed run completes exactly total_timesteps overall, not
    total_timesteps more."""
    env = MatrixGame(n_agents=2, n_actions=3, episode_limit=8, device="cpu")
    base = dict(env_type="matrix", num_envs=4, buffer_size=256, learning_starts=64,
                log_interval=16, eval_steps=10**9, checkpoint_dir=str(tmp_path / "ckpt"),
                checkpoint_every=256, seed=0, verbose=False, device="cpu")
    logger = types.SimpleNamespace(log=lambda *a: None, close=lambda: None)

    def env_steps(r):
        return r.step * 4

    runner1, _ = vdn.train(vdn.VDNConfig(total_timesteps=512, **base), env, logger=logger)
    assert env_steps(runner1) == 512
    assert sorted(int(p.name) for p in (tmp_path / "ckpt").iterdir()) == [256, 512]
    runner2, _ = vdn.train(vdn.VDNConfig(total_timesteps=1024, resume=True, **base), env,
                           logger=logger)
    assert env_steps(runner2) == 1024
    runner3, _ = vdn.train(vdn.VDNConfig(total_timesteps=1024, resume=True, **base), env,
                           logger=logger)
    assert env_steps(runner3) == 1024
    assert sorted(int(p.name) for p in (tmp_path / "ckpt").iterdir()) == [512, 768, 1024]


def _small_runner():
    init, _, _, _ = coma.make_train(coma.COMAConfig(**FAMILIES["coma"][2], device="cpu"))
    return init, init(torch.Generator().manual_seed(0))


def test_max_to_keep_prunes_the_oldest(tmp_path):
    _, runner = _small_runner()
    ckpt = _checkpointer(tmp_path, "coma", max_to_keep=2)
    for step in (10, 20, 30, 40):
        ckpt.save(step, runner)
    assert ckpt.all_steps() == [30, 40]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["30", "40"]


def test_half_written_step_is_ignored(tmp_path):
    init, runner = _small_runner()
    ckpt = _checkpointer(tmp_path, "coma")
    ckpt.save(10, runner)
    # a run killed while writing step 20: the temporary directory with a
    # partial file, and a step directory that never got its metadata
    os.makedirs(tmp_path / ".tmp-20")
    (tmp_path / ".tmp-20" / "rank0.pt.part").write_bytes(b"\x00" * 7)
    os.makedirs(tmp_path / "30")
    assert ckpt.latest_step() == 10
    assert_identical(ckpt.restore(init(torch.Generator().manual_seed(3))), runner)
    ckpt.save(20, runner)                       # the leftovers do not block a save
    assert ckpt.latest_step() == 20 and not (tmp_path / ".tmp-20").exists()


def test_template_of_another_shape_raises_naming_the_field(tmp_path):
    _, runner = _small_runner()
    ckpt = _checkpointer(tmp_path, "coma")
    ckpt.save(10, runner)
    init8, _, _, _ = coma.make_train(coma.COMAConfig(**dict(FAMILIES["coma"][2], num_envs=8),
                                                     device="cpu"))
    with pytest.raises(ValueError, match=r"runner\.env_state\.t: shape \(4,\) in the file, "
                       r"\(8,\) in the runner"):
        ckpt.restore(init8(torch.Generator().manual_seed(0)))


def test_another_optimizer_raises_naming_the_field(tmp_path):
    """An ``adam`` runner's checkpoint restored into a ``lamb`` runner: the
    two states are both Adam moments, but the layouts differ by name."""
    make_train, config, kw = FAMILIES["mappo"]
    init, _, _, _ = make_train(config(**kw, device="cpu"))
    runner = init(torch.Generator().manual_seed(0))
    ckpt = _checkpointer(tmp_path, "mappo")
    ckpt.save(10, runner)
    init_lamb, _, _, _ = make_train(config(**dict(kw, optimizer="lamb"), device="cpu"))
    with pytest.raises(ValueError, match=r"runner\.actor_opt: keys \['count', 'mu', 'nu'\] "
                       r"in the file, \['count', 'lamb'\] in the runner"):
        ckpt.restore(init_lamb(torch.Generator().manual_seed(0)))


def test_use_wnb_reaches_wandb_init(monkeypatch, tmp_path):
    calls = {}
    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: calls.update(kw)
    fake.finish = lambda: calls.setdefault("finished", True)
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.chdir(tmp_path)

    from cleanmarl_tpu_torch.core.logger import Logger

    cfg = vdn.VDNConfig(env_type="matrix", use_wnb=True, wnb_project="proj",
                        wnb_entity="ent")
    logger = Logger("VDN", cfg, use_wnb=cfg.use_wnb)
    assert calls["project"] == "proj"
    assert calls["entity"] == "ent"
    assert calls["sync_tensorboard"] is True
    assert calls["config"]["use_wnb"] is True
    logger.close()
    assert calls.get("finished") is True
