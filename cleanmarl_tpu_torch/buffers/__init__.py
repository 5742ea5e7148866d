"""Replay storage on the device (port of ``cleanmarl_tpu/buffers``): the
flat transition ring (VDN) and the padded episode ring with its per-env
accumulator (QMIX)."""
