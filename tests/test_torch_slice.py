"""The port's slice end to end on the CPU: recurrent MAPPO on SMAClite 3m
through ``make_train`` (two ``train_block``s and one ``eval_fn``) and
through the CLI, with the JAX package's metric keys; the import guard;
and the refusal to run on a card that is not there."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cleanmarl_tpu.algos import mappo as jmappo
from cleanmarl_tpu.algos.ppo_common import PPOConfig as JaxPPOConfig
from cleanmarl_tpu_torch.algos import mappo as tmappo
from cleanmarl_tpu_torch.algos import qmix as tqmix
from cleanmarl_tpu_torch.algos import vdn as tvdn
from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig
from cleanmarl_tpu_torch.algos.qmix import QMIXConfig
from cleanmarl_tpu_torch.algos.vdn import VDNConfig
from cleanmarl_tpu_torch.core.device import resolve_device
from cleanmarl_tpu_torch.core.driver import to_host

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(env_type="smaclite", env_name="3m", recurrent=True, num_envs=8,
            rollout_len=12, actor_hidden_dim=16, critic_hidden_dim=16, epochs=2,
            num_minibatches=2, log_interval=2, num_eval_ep=3,
            total_timesteps=2 * 8 * 12 * 2, seed=0, verbose=False)


def test_slice_train_blocks_and_eval_on_cpu():
    jinit, jblock, jeval, jmeta = jmappo.make_train(JaxPPOConfig(**TINY))
    jrunner = jax.eval_shape(jinit, jax.random.PRNGKey(0))
    _, jmetrics = jax.eval_shape(jblock, jrunner)
    jevals = jax.eval_shape(jeval, jrunner.actor_params, jax.random.PRNGKey(1))

    init, train_block, eval_fn, meta = tmappo.make_train(PPOConfig(**TINY, device="cpu"))
    assert meta["steps_per_block"] == jmeta["steps_per_block"]
    assert meta["model_flops_per_step"] == pytest.approx(jmeta["model_flops_per_step"])
    assert meta["gru_impl"] == "scan"
    runner = init(torch.Generator().manual_seed(0))
    for block in range(2):
        runner, metrics = train_block(runner)
        host = to_host(metrics)
        assert sorted(host) == sorted(jmetrics)
        assert all(np.isfinite(v) for v in host.values())
        assert runner.step == (block + 1) * meta["steps_per_block"]
        assert host["train/num_updates"] == (block + 1) * 2 * TINY["epochs"] * 2
    evals = to_host(eval_fn(runner.actor_params, torch.Generator().manual_seed(1)))
    assert sorted(evals) == sorted(jevals)
    assert 1 <= evals["eval/ep_length"] <= 150
    assert all(np.isfinite(v) for v in evals.values())


def test_cli_runs_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    tmappo.main(["--recurrent", "true", "--env_type", "smaclite", "--env_name", "3m",
                 "--device", "cpu", "--num_envs", "4", "--rollout_len", "10",
                 "--log_interval", "1", "--total_timesteps", "80",
                 "--eval_steps", "40", "--num_eval_ep", "2", "--epochs", "1",
                 "--actor_hidden_dim", "8", "--critic_hidden_dim", "8",
                 "--gru_impl", "xla"])
    out = capsys.readouterr().out
    assert "[MAPPO] step=40" in out and "[MAPPO] step=80" in out
    assert any(p.name.startswith("MAPPO-smaclite__3m") for p in (tmp_path / "runs").iterdir())


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import cleanmarl_tpu_torch\n"
        "for m in pkgutil.walk_packages(cleanmarl_tpu_torch.__path__, "
        "'cleanmarl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cleanmarl_tpu', 'optax', 'chex', 'flax')]\n"
        "print(len([m for m in sys.modules if m.startswith('cleanmarl_tpu_torch')]))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmappo.make_train(PPOConfig(**TINY))          # device defaults to "cuda"
    spread = dict(env_type="mpe", env_name="simple_spread_v3", num_envs=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tqmix.make_train(QMIXConfig(**spread))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvdn.make_train(VDNConfig(**spread))


@pytest.mark.parametrize("option", [dict(checkpoint_dir="ckpt"), dict(use_mesh=True),
                                    dict(profile_dir="prof"), dict(num_processes=2)],
                         ids=["checkpoint", "mesh", "profile", "multiprocess"])
def test_unported_driver_options_raise(option, tmp_path, monkeypatch):
    """The driver options that raised before they were ported now run for
    MAPPO with one rank: the checkpoint leaves the final step's directory,
    the profile a trace, ``use_mesh`` on the CPU does nothing, and
    ``num_processes`` without a coordinator runs one process, as in the
    JAX package."""
    monkeypatch.chdir(tmp_path)
    runner, _ = tmappo.train(PPOConfig(**TINY, device="cpu", **option))
    assert runner.step == TINY["total_timesteps"]
    if "checkpoint_dir" in option:
        assert (tmp_path / "ckpt" / str(TINY["total_timesteps"])).is_dir()
    if "profile_dir" in option:
        assert any((tmp_path / "prof").iterdir())


@pytest.mark.parametrize("kw", [dict(gru_impl="pallas", tbptt=2),
                                dict(gru_impl="kernel", compute_dtype="bfloat16"),
                                dict(gru_impl="fast"),
                                dict(normalize_values=True, normalize_return=True),
                                dict(num_minibatches=3)],
                         ids=["kernel_tbptt", "kernel_bf16", "bad_impl",
                              "two_value_norms", "uneven_minibatches"])
def test_make_train_rejects_bad_configs(kw):
    with pytest.raises(ValueError):
        tmappo.make_train(PPOConfig(**dict(TINY, **kw), device="cpu"))
