"""Port parity: recurrent QMIX and VDN of ``cleanmarl_tpu_torch``
(``algos/recurrent_q.py``, ``networks.rnn_seq_eval_next``) against the JAX
package, on the CPU.

- ``rnn_seq_eval_next`` on both routes (the scan, and the kernel route,
  which on CPU tensors runs the kernels' plain versions: one sequence
  forward, then one batched GRU step) and ``rnn_initial_state`` against
  the JAX functions at 1e-5;
- one episode-replay update (``meta["update"]``) against the same update
  assembled here from the JAX package's functions as
  ``recurrent_q.py:313-354`` does, from copied params and Adam state and
  an injected batch: loss, grad norm and new params at 1e-5, for vdn and
  qmix, ``normalize_reward`` on and off, ``tbptt=3`` on the scan route and
  the kernel route with its hand-written backward;
- one sequence-replay update (``meta["update_seq"]``) with and without
  burn-in against ``recurrent_q.py:253-311`` assembled the same way, at
  1e-5;
- two ``train_block``s on the matrix game against the JAX ``make_train``:
  the JAX metric keys, finite values, and ``train/num_updates``,
  ``train/update_debt`` and episodes per block equal, capped and uncapped
  (episode clock) and with sequence replay (iteration clock);
- the hidden state is zero after every episode ends; the config guards;
  both CLIs; ``device="cuda"`` raising without a card.

The JAX learning tests (``tests/test_recurrent_q.py:39-50``) are not
mirrored: their 40,000 env steps of eager updates take about a minute
each on one CPU worker. The learning receipt on the card stands in.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cleanmarl_tpu.algos import recurrent_q as jrq
from cleanmarl_tpu.core import networks as jnets
from cleanmarl_tpu.core.optim import make_optimizer as jmake_optimizer
from cleanmarl_tpu.core.rewards import standardize as jstandardize
from cleanmarl_tpu_torch.algos import qmix_rnn, recurrent_q, vdn_rnn
from cleanmarl_tpu_torch.core import networks as nets
from cleanmarl_tpu_torch.core.driver import to_host
from cleanmarl_tpu_torch.core.params import (
    from_numpy_tree, opt_state_from_numpy, tree_map,
)
from cleanmarl_tpu_torch.envs import registry as treg

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def assert_tree_close(port_tree, np_tree_, **tol):
    """Leaf by leaf, matched by key (the JAX tree's dict order differs)."""
    tree_map(lambda a, b: np.testing.assert_allclose(a.detach().numpy(), b, **tol),
             port_tree, np_tree_)


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["scan", "kernel"])
def test_rnn_seq_eval_next_matches_jax(impl):
    T, B, n, in_dim, H, A = 9, 4, 3, 11, 16, 5
    jp = jnets.rnn_init(jax.random.PRNGKey(0), in_dim, H, A)
    rng = np.random.RandomState(0)
    obs = rng.randn(T, B, n, in_dim).astype(np.float32)
    next_obs = rng.randn(T, B, n, in_dim).astype(np.float32)
    h0 = (0.3 * rng.randn(B, n, H)).astype(np.float32)
    want = np.asarray(jnets.rnn_seq_eval_next(jp, jnp.asarray(h0), jnp.asarray(obs),
                                              jnp.asarray(next_obs)))
    got = nets.rnn_seq_eval_next(from_numpy_tree(np_tree(jp), "cpu"), torch.as_tensor(h0),
                                 torch.as_tensor(obs), torch.as_tensor(next_obs), impl=impl)
    assert got.shape == (T, B, n, A)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    jz = np.asarray(jnets.rnn_initial_state((B, n), H))
    z = nets.rnn_initial_state((B, n), H)
    assert z.dtype == torch.float32 and z.shape == jz.shape and not z.any()
    with pytest.raises(ValueError):
        nets.rnn_seq_eval_next(from_numpy_tree(np_tree(jp), "cpu"), torch.as_tensor(h0),
                               torch.as_tensor(obs), torch.as_tensor(next_obs),
                               dtype=torch.bfloat16, impl="pallas")


# ---------------------------------------------------------------------------
# one update
# ---------------------------------------------------------------------------

B, T, L, H = 5, 12, 6, 16
EPISODE_CASES = {
    "vdn": dict(mixing="vdn"),
    "vdn_normalize": dict(mixing="vdn", normalize_reward=True),
    "qmix": dict(mixing="qmix"),
    "qmix_normalize": dict(mixing="qmix", normalize_reward=True),
    "qmix_tbptt3_scan": dict(mixing="qmix", tbptt=3, gru_impl="xla"),
    "qmix_kernel_route": dict(mixing="qmix", gru_impl="kernel"),
    "qmix_rmsprop": dict(mixing="qmix", optimizer="rmsprop"),
}
SEQUENCE_CASES = {
    "burn_in_3_normalize": dict(burn_in=3, normalize_reward=True),
    "no_burn_in_kernel_route": dict(burn_in=0, gru_impl="kernel"),
}


def jax_update(cfg, params, target_params, opt_state, batch, mask):
    """``recurrent_q.py:313-354`` from the JAX package's own functions, on
    episodes that are already sampled."""
    opt = jmake_optimizer(cfg.optimizer, cfg.learning_rate, cfg.clip_gradients)
    tm = jax.tree.map(lambda x: jnp.moveaxis(x, 0, 1), batch)
    mask_tm = jnp.moveaxis(mask, 0, 1)
    if cfg.normalize_reward:
        tm = {**tm, "reward": jstandardize(tm["reward"], mask_tm)}
    h0 = jnp.zeros((mask.shape[0], tm["obs"].shape[2], cfg.hidden_dim))

    def mix(p, qs, state):
        return jnets.mixer_apply(p["mixer"], qs, state) if cfg.mixing == "qmix" else qs.sum(-1)
    q_next = jnets.rnn_seq_eval_next(target_params["q"], h0, tm["obs"], tm["next_obs"])
    q_next_max = jnets.masked_q(q_next, tm["next_avail"]).max(axis=-1)
    team_next = mix(target_params, q_next_max, tm["next_state"])
    target = tm["reward"] + cfg.gamma * (1.0 - tm["done"].astype(jnp.float32)) * team_next

    def loss_fn(p):
        _, q = jnets.rnn_seq_apply(p["q"], h0, tm["obs"], tbptt=cfg.tbptt)
        q_taken = jnp.take_along_axis(q, tm["action"][..., None], axis=-1)[..., 0]
        err = jnp.square(target - mix(p, q_taken, tm["state"])) * mask_tm
        return jnp.sum(err) / jnp.maximum(jnp.sum(mask_tm), 1.0)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = opt.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss, jnets.global_norm(grads)


def jax_update_seq(cfg, params, target_params, opt_state, batch):
    """``recurrent_q.py:253-311`` from the JAX package's own functions."""
    opt = jmake_optimizer(cfg.optimizer, cfg.learning_rate, cfg.clip_gradients)
    tm = jax.tree.map(lambda x: jnp.moveaxis(x, 0, 1), batch)
    reward = jstandardize(tm["reward"]) if cfg.normalize_reward else tm["reward"]
    bi = cfg.burn_in
    h_t = h_u = jnp.zeros((tm["obs"].shape[1], tm["obs"].shape[2], cfg.hidden_dim))
    gi_t = jnets.gru_input_proj(target_params["q"], tm["next_obs"][:bi])
    gi_u = jnets.gru_input_proj(params["q"], tm["obs"][:bi])
    for t in range(bi):
        h_t = jnets.gru_apply_pre(target_params["q"]["gru"], h_t, gi_t[t])
        h_u = jnets.gru_apply_pre(params["q"]["gru"], h_u, gi_u[t])
    _, q_next = jnets.rnn_seq_apply(target_params["q"], h_t, tm["next_obs"][bi:])
    q_next_max = jnets.masked_q(q_next, tm["next_avail"][bi:]).max(axis=-1)
    done = tm["done"][bi:].astype(jnp.float32)
    target = reward[bi:] + cfg.gamma * (1.0 - done) * q_next_max.sum(axis=-1)

    def loss_fn(p):
        _, q = jnets.rnn_seq_apply(p["q"], h_u, tm["obs"][bi:])
        q_taken = jnp.take_along_axis(q, tm["action"][bi:][..., None], axis=-1)[..., 0]
        return jnp.mean(jnp.square(target - q_taken.sum(axis=-1)))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = opt.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss, jnets.global_norm(grads)


def make_batch(rng, env, steps):
    n, A, O, S = env.n_agents, env.n_actions, env.obs_dim, env.state_dim

    def avail():
        a = rng.rand(B, steps, n, A) < 0.7
        a[..., rng.randint(A)] = True
        return a
    av = avail()
    return {"obs": rng.randn(B, steps, n, O).astype(np.float32),
            "state": rng.randn(B, steps, S).astype(np.float32),
            "action": (rng.rand(B, steps, n, A) * av).argmax(-1).astype(np.int32),
            "reward": rng.randn(B, steps).astype(np.float32) - 1.0,
            "done": rng.rand(B, steps) < 0.1,
            "next_obs": rng.randn(B, steps, n, O).astype(np.float32),
            "next_state": rng.randn(B, steps, S).astype(np.float32),
            "next_avail": avail()}


def to_torch_batch(batch):
    out = {k: torch.as_tensor(v) for k, v in batch.items()}
    out["action"] = out["action"].long()
    return out


def start(jcfg, env, seed):
    """JAX params, a perturbed target and a fresh optimizer state."""
    k = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = {"q": jnets.rnn_init(k[0], env.obs_dim, H, env.n_actions)}
    if jcfg.mixing == "qmix":
        params["mixer"] = jnets.mixer_init(k[1], env.n_agents, env.state_dim, 8, H)
    leaves, tdef = jax.tree.flatten(params)
    noise = jax.random.split(k[2], len(leaves))
    target = jax.tree.unflatten(tdef, [p + 0.05 * jax.random.normal(nk, p.shape)
                                       for p, nk in zip(leaves, noise)])
    opt = jmake_optimizer(jcfg.optimizer, jcfg.learning_rate, jcfg.clip_gradients)
    return params, target, opt.init(params)


def run_update_pair(kw, seq, seed):
    """Two JAX updates (the first fills the optimizer state) and the port's
    second update from the JAX state after the first → (port, JAX)."""
    env = treg.make("smaclite", "3m", agent_ids=True, device="cpu")
    base = dict(env_type="smaclite", env_name="3m", hidden_dim=H, hyper_dim=H,
                embed_dim=8, learning_rate=3e-3, seq_length=L, **kw)
    jcfg = jrq.RecurrentQConfig(**{k: v for k, v in base.items() if k != "gru_impl"},
                                replay="sequence" if seq else "episode")
    params, target, opt_state = start(jcfg, env, seed)
    rng = np.random.RandomState(seed)
    jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    steps = L if seq else T
    batches = [make_batch(rng, env, steps) for _ in range(2)]
    masks = [(np.arange(T)[None] < rng.randint(1, T + 1, (B, 1))).astype(np.float32)
             for _ in range(2)]
    if seq:
        jupdate = jax.jit(functools.partial(jax_update_seq, jcfg))
        params, opt_state, _, _ = jupdate(params, target, opt_state, jb(batches[0]))
        want = jupdate(params, target, opt_state, jb(batches[1]))
    else:
        jupdate = jax.jit(functools.partial(jax_update, jcfg))
        params, opt_state, _, _ = jupdate(params, target, opt_state, jb(batches[0]),
                                          jnp.asarray(masks[0]))
        want = jupdate(params, target, opt_state, jb(batches[1]), jnp.asarray(masks[1]))
    cfg = recurrent_q.RecurrentQConfig(**base, replay=jcfg.replay, device="cpu")
    _, _, _, meta = recurrent_q.make_train(cfg, env)
    state = (from_numpy_tree(np_tree(params), "cpu"), from_numpy_tree(np_tree(target), "cpu"),
             opt_state_from_numpy(np_tree(opt_state), "cpu", jcfg.optimizer, count=1),
             to_torch_batch(batches[1]))
    got = (meta["update_seq"](*state) if seq
           else meta["update"](*state, torch.as_tensor(masks[1])))
    return got, want


def check_update(got, want):
    got_p, got_o, loss, gnorm = got
    want_p, _, want_loss, want_gnorm = want
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    np.testing.assert_allclose(float(gnorm), float(want_gnorm), **TOL)
    assert_tree_close(got_p, np_tree(want_p), **TOL)
    assert got_o["count"] == 2


@pytest.mark.parametrize("case", sorted(EPISODE_CASES))
def test_episode_update_matches_jax(case):
    check_update(*run_update_pair(EPISODE_CASES[case], seq=False, seed=len(case)))


@pytest.mark.parametrize("case", sorted(SEQUENCE_CASES))
def test_sequence_update_matches_jax(case):
    check_update(*run_update_pair(SEQUENCE_CASES[case], seq=True, seed=len(case)))


def test_kernel_route_gets_contiguous_inputs(monkeypatch):
    """The update hands the GRU kernels' autograd function contiguous gi,
    h0 and keep (the sampled batch is made time-major and contiguous once),
    so ``GruSeq.forward`` copies nothing. Two calls per update: the target
    stream's and the online stream's (whose backward reuses its saved
    inputs and writes gi's gradient over gi, the network's own)."""
    from cleanmarl_tpu_torch.ops import gru_kernel

    seen = []
    real = gru_kernel.gru_seq

    def spy(wh, bh, h0, gi, keep, consume_gi=False):
        seen.append((all(x.is_contiguous() for x in (wh, bh, h0, gi, keep)), consume_gi))
        return real(wh, bh, h0, gi, keep, consume_gi=consume_gi)
    monkeypatch.setattr(gru_kernel, "gru_seq", spy)
    env = treg.make("smaclite", "3m", agent_ids=True, device="cpu")
    cfg = recurrent_q.RecurrentQConfig(env_type="smaclite", env_name="3m", mixing="qmix",
                                       hidden_dim=H, hyper_dim=H, embed_dim=8,
                                       gru_impl="kernel", device="cpu")
    init, _, _, meta = recurrent_q.make_train(cfg, env)
    runner = init(torch.Generator().manual_seed(0))
    batch = to_torch_batch(make_batch(np.random.RandomState(0), env, T))
    mask = torch.ones(B, T)
    meta["update"](runner.params, runner.target_params, runner.opt_state, batch, mask)
    assert seen == [(True, True), (True, True)]


# ---------------------------------------------------------------------------
# the slice: train blocks, hidden resets, guards, CLIs
# ---------------------------------------------------------------------------

TINY = dict(env_type="matrix", num_envs=4, buffer_size=16, batch_size=4, log_interval=8,
            hidden_dim=8, hyper_dim=8, embed_dim=4, seq_length=4, burn_in=2,
            num_eval_ep=2, total_timesteps=2 * 4 * 8, seed=0, verbose=False)
BLOCK_CASES = {
    # every matrix-game env ends at step 8: 4 episodes at each 8th iteration
    "episode_uncapped": (dict(mixing="qmix"), [(4, 0), (8, 0)]),
    "episode_capped": (dict(mixing="qmix", max_updates_per_iter=2), [(2, 2), (6, 2)]),
    # 4 chunks commit at each 4th iteration; warm from iteration 4 on
    "sequence": (dict(mixing="vdn", replay="sequence"), [(5, 0), (13, 0)]),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_train_blocks_match_jax_clock(case):
    kw, want_counts = BLOCK_CASES[case]
    kw = dict(TINY, **kw)
    jinit, jblock, jeval = jrq.make_train(jrq.RecurrentQConfig(**kw))
    jrunner = jinit(jax.random.PRNGKey(0))
    init, train_block, eval_fn, meta = recurrent_q.make_train(
        recurrent_q.RecurrentQConfig(**kw, device="cpu"))
    assert meta["steps_per_block"] == 4 * 8 and meta["gru_impl"] == "scan"
    runner = init(torch.Generator().manual_seed(0))
    counts = []
    for _ in range(2):
        jrunner, jmetrics = jblock(jrunner)
        runner, metrics = train_block(runner)
        host = to_host(metrics)
        assert sorted(host) == sorted(jmetrics)
        assert all(np.isfinite(v) for v in host.values())
        for k in ("train/num_updates", "train/update_debt", "rollout/num_episodes"):
            assert host[k] == float(jmetrics[k]), k
        assert (runner.step, runner.episodes, runner.num_updates, runner.update_debt) == (
            int(jrunner.step), int(jrunner.episodes), int(jrunner.num_updates),
            int(jrunner.update_debt))
        assert (runner.ring.cursor, runner.ring.size) == (int(jrunner.ring.cursor),
                                                          int(jrunner.ring.size))
        counts.append((host["train/num_updates"], host["train/update_debt"]))
    assert counts == want_counts
    evals = to_host(eval_fn(runner.params, torch.Generator().manual_seed(1)))
    assert sorted(evals) == sorted(jax.eval_shape(jeval, jrunner.params,
                                                  jax.random.PRNGKey(1)))
    assert evals["eval/ep_length"] == 8.0 and all(np.isfinite(v) for v in evals.values())


def test_hidden_state_resets_between_episodes():
    init, train_block, _, meta = recurrent_q.make_train(
        recurrent_q.RecurrentQConfig(**TINY, device="cpu"))
    runner = init(torch.Generator().manual_seed(0))
    for _ in range(3):
        runner, _ = meta["train_iter"](runner)
    assert float(runner.h.abs().sum()) > 0                # mid-episode
    for _ in range(5):
        runner, _ = meta["train_iter"](runner)
    assert runner.step == 8
    assert float(runner.h.abs().sum()) == 0.0             # every env ended at step 8
    runner, _ = train_block(runner)
    assert runner.step == 16 and float(runner.h.abs().sum()) == 0.0


@pytest.mark.parametrize("kw,match", [
    (dict(mixing="iql"), "mixing"), (dict(replay="chunks"), "replay"),
    (dict(replay="sequence", mixing="qmix"), "mixing vdn"),
    (dict(replay="sequence", burn_in=10, seq_length=10), "burn_in"),
    (dict(replay="sequence", burn_in=-1), "burn_in"),
    (dict(compute_dtype="float16"), "compute_dtype"), (dict(gru_impl="fast"), "gru_impl"),
    (dict(gru_impl="pallas", tbptt=2), "tbptt"), (dict(gru_impl="kernel", tbptt=2), "tbptt"),
    (dict(gru_impl="pallas", compute_dtype="bfloat16"), "bfloat16"),
    (dict(gru_impl="kernel", compute_dtype="bfloat16"), "bfloat16")],
    ids=["mixing", "replay", "seq_qmix", "burn_in_long", "burn_in_negative", "dtype",
         "impl", "pallas_tbptt", "kernel_tbptt", "pallas_bf16", "kernel_bf16"])
def test_config_guards(kw, match):
    with pytest.raises(ValueError, match=match):
        recurrent_q.make_train(recurrent_q.RecurrentQConfig(**dict(TINY, **kw), device="cpu"))


def test_bf16_and_tbptt_take_the_scan():
    for kw in (dict(tbptt=3), dict(compute_dtype="bfloat16")):
        _, _, _, meta = recurrent_q.make_train(
            recurrent_q.RecurrentQConfig(**dict(TINY, **kw), device="cpu"))
        assert meta["gru_impl"] == "scan"


@pytest.mark.parametrize("cli,name", [(qmix_rnn, "QMIX-RNN"), (vdn_rnn, "VDN-RNN")],
                         ids=["qmix_rnn", "vdn_rnn"])
def test_cli_runs_on_cpu(cli, name, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    extra = ["--replay", "sequence", "--seq_length", "4", "--burn_in", "2"] if (
        cli is vdn_rnn) else []
    runner, _ = cli.main(["--env_type", "matrix", "--device", "cpu", "--num_envs", "4",
                          "--buffer_size", "16", "--batch_size", "4", "--log_interval", "8",
                          "--total_timesteps", "64", "--eval_steps", "32",
                          "--num_eval_ep", "2", "--hidden_dim", "8", "--hyper_dim", "8",
                          "--embed_dim", "4"] + extra)
    out = capsys.readouterr().out
    assert f"[{name}] step=32" in out and f"[{name}] step=64" in out
    eval_line = next(x for x in out.splitlines() if x.startswith(f"[{name}] eval step=64 "))
    assert " ep_reward=" in eval_line and " battle_won=" in eval_line
    assert runner.num_updates > 0 and ("mixer" in runner.params) == (name == "QMIX-RNN")
    assert any(p.name.startswith(f"{name}-matrix__") for p in (tmp_path / "runs").iterdir())


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        recurrent_q.make_train(recurrent_q.RecurrentQConfig(env_type="matrix"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        qmix_rnn.main(["--env_type", "matrix"])
