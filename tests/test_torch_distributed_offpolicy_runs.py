"""Data parallelism of the port's off-policy families over
``torch.distributed`` (gloo on the CPU), the driven path; the commit and
the one-update checks against the JAX package are in
``tests/test_torch_distributed_offpolicy.py``.

- **One rank** through the data-parallel path (a 1-rank process group)
  is bit-identical to the plain path, for QMIX, VDN, recurrent Q with
  episode and sequence replay, MADDPG with a GRU actor and FACMAC.
- **Two-rank blocks** (``tests/test_distributed.py:98-146, 193-343``):
  params identical on both ranks, ``episodes``, ``cursor`` and ``size``
  global and equal, each rank holding its rows of the ring (capacities 2
  divides and does not).
- **Cluster** (``tests/test_multihost.py:137-178``): a 2-process QMIX CLI
  run saves one file of ring rows per rank, and a resumed one ends at
  ``total_timesteps``, not marked slow.
"""
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _dp_ranks
from cleanmarl_tpu_torch.core.checkpoint import to_state
from cleanmarl_tpu_torch.core.params import tree_leaves
from cleanmarl_tpu_torch.distributed import dp

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


def same_trees(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        np.testing.assert_array_equal(x, y)


_COMMON = dict(seed=0, verbose=False, num_eval_ep=1, eval_steps=10**6)
_SPREAD = dict(env_type="mpe", env_name="simple_spread_v3", num_envs=4, log_interval=25,
               total_timesteps=4 * 25 * 2, **_COMMON)
_SL = dict(_SPREAD, env_name="simple_speaker_listener_v4", buffer_size=9, batch_size=4,
           actor_hidden_dim=8, critic_hidden_dim=8)
_MATRIX = dict(env_type="matrix", num_envs=4, batch_size=4, log_interval=8,
               total_timesteps=4 * 8 * 2, hidden_dim=8, **_COMMON)
BLOCKS = {
    "qmix": ("qmix", dict(_SPREAD, buffer_size=9, batch_size=4, hidden_dim=8, hyper_dim=8,
                          embed_dim=4, normalize_reward=True)),
    "vdn": ("vdn", dict(_SPREAD, buffer_size=150, batch_size=4, learning_starts=40,
                        hidden_dim=8, normalize_reward=True)),
    "recurrent_qmix_episode": ("recq", dict(_MATRIX, mixing="qmix", buffer_size=15,
                                            hyper_dim=8, embed_dim=4)),
    "recurrent_vdn_sequence": ("recq", dict(_MATRIX, mixing="vdn", replay="sequence",
                                            seq_length=4, burn_in=2, buffer_size=17)),
    "maddpg_gru_actor": ("maddpg", dict(_SL, recurrent=True)),
    "facmac": ("facmac", dict(_SL, hyper_dim=8, embed_dim=4, exploration_fraction=6.0)),
}


def _logger():
    return types.SimpleNamespace(log=lambda *a: None, close=lambda: None)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_one_rank_dp_path_is_bit_identical_to_plain(name):
    family, kw = BLOCKS[name]
    mod, cls = _dp_ranks._family(family)
    cfg = cls(**kw, device="cpu")
    plain, _ = mod.train(cfg, logger=_logger())
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_dp_ranks.free_port()}",
                            world_size=1, rank=0)
    try:
        dp_run, _ = mod.train(cfg, logger=_logger())
    finally:
        dist.destroy_process_group()
    assert plain.num_updates > 0
    flat = lambda r: tree_leaves(to_state(r))  # noqa: E731
    for a, b in zip(flat(plain), flat(dp_run), strict=True):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


@pytest.fixture(scope="module")
def block_results():
    return _dp_ranks.run_ranks(_dp_ranks.offpolicy_blocks, WORLD, BLOCKS)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_two_rank_blocks_keep_params_identical_and_counters_global(name, block_results):
    family, kw = BLOCKS[name]
    ranks = [b[name] for b in block_results]
    same_trees(ranks[1]["init_params"], ranks[0]["init_params"])   # rank 0's, broadcast
    same_trees(ranks[1]["params"], ranks[0]["params"])
    if kw["env_type"] == "mpe":        # own env streams (the matrix game's obs are fixed)
        assert not np.array_equal(ranks[0]["obs"], ranks[1]["obs"])
    cap = kw["buffer_size"]
    for r, got in enumerate(ranks):
        assert got["local_envs"] == kw["num_envs"] // WORLD
        assert got["step"] == ranks[0]["step"] == 2 * kw["log_interval"]
        for k in ("episodes", "num_updates", "cursor", "size"):
            assert got[k] == ranks[0][k], k
        assert got["metrics"] == ranks[0]["metrics"]
        assert got["capacity"] == cap
        assert got["rows"] == dp.owned_rows(cap, r, WORLD) + (family != "vdn")
    assert ranks[0]["num_updates"] > 0
    if kw["env_type"] == "mpe":        # every env truncates together at step 25
        assert ranks[0]["episodes"] in (None, kw["num_envs"] * 2)
        episodes = sum(m["rollout/num_episodes"] for m in ranks[0]["metrics"])
        assert episodes == kw["num_envs"] * 2


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return env


CLI = ["-m", "cleanmarl_tpu_torch.algos.qmix", "--env_type", "matrix", "--device", "cpu",
       "--num_envs", "16", "--buffer_size", "63", "--batch_size", "8", "--log_interval", "8",
       "--eval_steps", "1000000", "--hidden_dim", "8", "--hyper_dim", "8", "--embed_dim", "4",
       "--seed", "0", "--verbose", "true"]


def test_two_process_qmix_cli_saves_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")

    def cluster(total, resume):
        port = _dp_ranks.free_port()
        procs = [subprocess.Popen(
            [sys.executable, *CLI, "--total_timesteps", str(total),
             "--checkpoint_dir", ckpt, "--checkpoint_every", "256",
             "--resume", str(resume).lower(),
             "--coordinator_address", f"localhost:{port}", "--num_processes", "2",
             "--process_id", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env(),
            cwd=str(tmp_path)) for i in range(2)]
        outs = [p.communicate(timeout=300)[0] for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-3000:]
        return outs

    outs = cluster(512, resume=False)
    assert "[QMIX] step=" in outs[0] and "[QMIX]" not in outs[1]
    assert "[dist] 2 ranks, backend gloo" in outs[0]
    assert sorted(int(p.name) for p in (tmp_path / "ckpt").iterdir()) == [256, 512]
    assert sorted(p.name for p in (tmp_path / "ckpt" / "512").iterdir()) == [
        "meta.json", "rank0.pt", "rank1.pt"]
    # each rank's file holds its rows of the 63 and a scratch row: 32 + 1, 31 + 1
    for r, rows in ((0, 33), (1, 32)):
        blob = torch.load(tmp_path / "ckpt" / "512" / f"rank{r}.pt", weights_only=True)
        assert blob["runner"]["ring"]["length"].shape == (rows,)
        assert blob["runner"]["ring"]["capacity"] == 63

    outs = cluster(1024, resume=True)
    assert "[QMIX] resumed from step 512" in outs[0]
    assert "resumed" not in outs[1]
    steps = [int(m) for m in re.findall(r"step=(\d+)", outs[0])]
    assert steps[0] > 512 and steps[-1] == 1024, steps
