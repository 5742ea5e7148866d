"""Replay storage on the device (port of ``cleanmarl_tpu/buffers``): the
flat transition ring (VDN, ``transition``), the padded episode ring with
its per-env accumulator (QMIX and recurrent Q, ``episode``), and the
fixed-length chunk ring with its back-filling accumulator (recurrent VDN
with sequence replay, ``sequence``)."""
