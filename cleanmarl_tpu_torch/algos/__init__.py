"""Algorithm implementations of the port, one module per algorithm, on
top of the shared envs/core/buffers/ops packages: IPPO and MAPPO
(feed-forward and recurrent) through ``ppo_common`` (``ippo``, ``mappo``),
QMIX (``qmix``), VDN (``vdn``), recurrent QMIX and VDN with episode or
sequence replay through ``recurrent_q`` (CLIs ``qmix_rnn`` and
``vdn_rnn``), MADDPG (feed-forward and GRU actors, ``maddpg``), FACMAC
(``facmac``) and COMA (feed-forward and GRU actors, ``coma``)."""
