"""cleanmarl_tpu_torch: the PyTorch + CUDA port of ``cleanmarl_tpu``.

The module tree mirrors the JAX package (``envs/``, ``core/``,
``buffers/``, ``ops/``, ``algos/``) so each module's counterpart is easy
to find. Ported: MAPPO on SMAClite, QMIX and VDN on MPE (and every env of
those families). Differences in idiom:

- envs are natively batched over a leading ``num_envs`` axis (no vmap);
- randomness comes from explicit ``torch.Generator``s, not PRNG keys;
- parameters are nested dicts of tensors in the JAX layout (dense ``w``
  is ``(in, out)``, the GRU keeps fused ``wi (in, 3H)``/``wh (H, 3H)`` in
  gate order r, z, n), so JAX params copy across unchanged
  (``core.params.from_numpy_tree``);
- every Pallas kernel of the JAX package is a hand-written CUDA kernel
  under ``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).

Entry points run on the card unless the caller asks for ``device="cpu"``.
The port imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"
