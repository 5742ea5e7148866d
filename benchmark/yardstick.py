"""The yardstick: the card's peaks, the least time of each kernel at its
shapes, and the model FLOPs of a training step.

Copied from the program's own arithmetic (the kernel bounds of the port's
chip check, ``gru_bounds`` and ``returns_bytes``; MAPPO's model FLOPs, the
program's ``model_flops_per_step``) so that it does not move when the
program is edited.
"""
from __future__ import annotations

# NVIDIA H100 SXM data-sheet peaks (dense), at the full 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12          # float32 FMA outside the tensor cores
PEAK_TF32_FLOPS = 495e12        # tensor cores; float32 accuracy takes 3 TF32 products
# the highest float32-accurate matmul rate: every float32 product as three
# TF32 products on the tensor cores (the port's GRU kernels), 495 / 3
PEAK_MATMUL_F32_FLOPS = PEAK_TF32_FLOPS / 3


def bound_s(n_bytes: float, n_flops: float, flops_per_s: float = PEAK_F32_FLOPS) -> float:
    """The least time: the larger of bytes over the memory bandwidth and
    operations over the given rate."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_flops / flops_per_s)


def gru_least_s(T: int, M: int, H: int) -> dict:
    """{"fwd", "bwd", "dw"}: the least seconds of one launch of K2 (the GRU
    forward over T steps of M rows), K3 (its backward recurrence) and dw
    (the recurrent weight's gradient), with the matmul operations as 3xTF32
    on the tensor cores and the gate arithmetic on the float32 units,
    against the bytes each needs: each input read once (the backward reads
    h_seq[:T-1] and keep[:T-1] as h_prev, and dgi's first 2H columns), each
    output written once."""
    f = 4
    flops = 2.0 * T * M * H * 3 * H
    fwd_bytes = f * (H * 3 * H + 3 * H + M * H + T * M * 3 * H + T * M + T * M * H + M * H)
    bwd_bytes = f * (H * 3 * H + 3 * H + M * H + (T - 1) * M * H + T * M * H
                     + T * M * 3 * H + T * M + M * H + T * M * 3 * H + T * M * H + M * H)
    dw_bytes = f * (M * H + (T - 1) * M * H + (T - 1) * M + T * M * 2 * H + T * M * H
                    + H * 3 * H + 3 * H)
    work = {"fwd": (fwd_bytes, flops, 10.0 * T * M * H),
            "bwd": (bwd_bytes, 2 * flops, 20.0 * T * M * H),
            "dw": (dw_bytes, flops, T * M * 3 * H)}
    return {k: bound_s(b, 3 * mm / PEAK_TF32_FLOPS * PEAK_F32_FLOPS + ew)
            for k, (b, mm, ew) in work.items()}


def returns_bytes(T: int, B: int, Rr: int, Rv: int, Re: int | None = None) -> int:
    """Bytes the λ-return function needs: G and A written (T, B), V read at
    (T, B / Rv), r (4 B) at (T, B / Rr), e (1 B) at (T, B / Re) (Re defaults
    to Rr), the bootstrap (B / Rv)."""
    Re = Rr if Re is None else Re
    return T * B * 8 + T * (B // Rv) * 4 + T * (B // Rr) * 4 + T * (B // Re) + (B // Rv) * 4


def returns_least_s(T: int, B: int, Rr: int, Rv: int) -> float:
    return returns_bytes(T, B, Rr, Rv) / PEAK_BYTES_PER_S


def mappo_flops_per_step(obs_dim: int, state_dim: int, n_agents: int, n_actions: int,
                         hidden: int, critic_hidden: int, critic_layers: int,
                         rollout_len: int, epochs: int) -> float:
    """Recurrent MAPPO's model FLOPs per env transition: 2 × the matmul MACs
    of the actor's acting step and of its forward in every epoch, the
    centralized critic's value in the rollout, its bootstrap and its forward
    in every epoch; backward counted as 2 × forward; bias adds and gating
    left out (``obs_dim`` is the width with the agent ids)."""
    H, Hc = hidden, critic_hidden
    macs_actor = obs_dim * H + H * 3 * H + H * 3 * H + H * n_actions
    macs_critic = state_dim * Hc + critic_layers * Hc * Hc + Hc
    critic_evals = 1 + 1.0 / rollout_len + 3 * epochs
    return 2.0 * (n_agents * macs_actor * (1 + 3 * epochs) + macs_critic * critic_evals)

