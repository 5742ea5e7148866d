"""Algorithm implementations of the port, one module per algorithm, on
top of the shared envs/core/buffers/ops packages. Ported so far: MAPPO
(feed-forward and recurrent) through ``ppo_common``, QMIX (``qmix``) and
VDN (``vdn``)."""
