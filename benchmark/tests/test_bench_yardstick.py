"""The copied roofline and FLOP arithmetic against hand-worked numbers and
against the program's own count, and the readers on a made-up trace."""
import pytest
from conftest import ROOT

from benchmark import harness, trace, yardstick as Y

MAIN = (60, 3072, 128)          # MAPPO's update: T, M = 1024 envs x 3 agents, H


def test_gru_least_times_at_the_main_shape():
    T, M, H = MAIN
    fwd_bytes = 4 * (H * 3 * H + 3 * H + M * H + T * M * 3 * H + T * M + T * M * H + M * H)
    assert fwd_bytes == 381_568_512
    least = Y.gru_least_s(T, M, H)
    assert least["fwd"] == pytest.approx(fwd_bytes / 3.35e12, rel=1e-12)   # bytes bound
    # the kernel table's bounds (PERF.md): 0.1139, 0.2548, 0.1130 ms
    assert least["fwd"] * 1e3 == pytest.approx(0.1139, rel=1e-3)
    assert least["bwd"] * 1e3 == pytest.approx(0.2548, rel=1e-3)
    assert least["dw"] * 1e3 == pytest.approx(0.1130, rel=1e-3)


def test_gru_least_time_bound_by_operations_at_width_256():
    T, M, H = 60, 3072, 256
    mm = 2.0 * T * M * H * 3 * H
    ops_s = 3 * mm / 495e12 + 10.0 * T * M * H / 67e12
    assert Y.gru_least_s(T, M, H)["fwd"] == pytest.approx(ops_s, rel=1e-12)


def test_returns_bytes_at_the_main_shape():
    # reward, flag and value per env broadcast over 3 agents
    assert Y.returns_bytes(60, 8192 * 3, 3, 3) == 16_252_928
    assert Y.returns_least_s(60, 8192 * 3, 3, 3) * 1e3 == pytest.approx(0.004852, rel=1e-3)


def test_mappo_flops_hand_worked_and_as_the_program_counts():
    # obs 30 + 3 ids, state 48, 9 actions: 16.69 MFLOP an env step
    f = Y.mappo_flops_per_step(33, 48, 3, 9, 128, 128, 1, 60, 8)
    assert f == pytest.approx(2 * (3 * 103_680 * 25 + 22_656 * (1 + 1 / 60 + 24)))
    assert f / 1e6 == pytest.approx(16.69, abs=0.01)
    from cleanmarl_tpu_torch.algos import mappo, ppo_common

    cell = harness.cell_spec("mappo_rnn_3m-8192envs")
    cfg = ppo_common.PPOConfig(**cell["config_file"]["params"], num_envs=16, device="cpu")
    assert mappo.make_train(cfg)[3]["model_flops_per_step"] == pytest.approx(f, rel=1e-12)


def ctx_of(**kw):
    ctx = {"kernels": {}, "shapes": {"gru": [MAIN], "returns": (60, 8192 * 3, 3, 3)},
           "wall_s": 2.0, "blocks": 1, "steps": 0, "busy_s": 1.5, "model_flops": 0.0,
           "spans": {}, "profiled_blocks": 1, "profiled_steps": 100}
    ctx.update(kw)
    return ctx


def test_readers_on_a_made_up_trace():
    k2 = "void gru_seq_fwd_tc_kernel<128, 2>(float const*, float*)"
    k3 = "void gru_seq_bwd_tc_kernel<128>(float const*)"
    dw = "void gru_seq_dw_tc_kernel<128>(float const*)"
    k1 = "void lambda_returns_kernel<3>(float const*)"
    ctx = ctx_of(kernels={k2: (64 * 0.5364e-3, 64), k3: (64 * 1.266e-3, 64),
                          dw: (64 * 0.3359e-3, 64), k1: (7.816e-6, 1)},
                 model_flops=16.685555e6 * 14e6, steps=14e6, wall_s=20.0, blocks=10,
                 busy_s=1.6)
    read = lambda name: harness.metric_reader(name, ROOT)(ctx)   # noqa: E731
    least = Y.gru_least_s(*MAIN)
    assert read("gru_fwd_roofline") == pytest.approx(100 * least["fwd"] / 0.5364e-3)
    assert read("gru_bwd_roofline") == pytest.approx(
        100 * (least["bwd"] + least["dw"]) / (1.266e-3 + 0.3359e-3))
    assert read("returns_roofline") == pytest.approx(100 * 4.8516e-6 / 7.816e-6, rel=1e-3)
    assert read("device_idle_share") == pytest.approx(20.0)
    assert read("mfu") == pytest.approx(100 * 16.685555e6 * 0.7e6 / 165e12)
    assert read("env_steps_per_s.window") == pytest.approx(0.7e6)


def test_readers_return_nothing_where_there_is_nothing_to_read():
    ctx = ctx_of(busy_s=0.0)
    for name in ("gru_fwd_roofline", "gru_bwd_roofline", "returns_roofline",
                 "device_idle_share", "mfu", "rollout_ms.mappo", "update_ms.mappo",
                 "env_steps_per_s.window"):
        assert harness.metric_reader(name, ROOT)(ctx) is None, name


def test_union_gaps_and_totals_of_device_intervals():
    ev = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("a", 20.0, 25.0), ("c", 30.0, 31.0)]
    assert trace.union_seconds(ev) == pytest.approx(18e-6)
    assert trace.gaps(ev) == [(12.0, 20.0), (25.0, 30.0)]
    assert trace.kernel_totals(ev)["a"] == pytest.approx((15e-6, 2))
