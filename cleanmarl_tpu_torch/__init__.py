"""cleanmarl_tpu_torch: the PyTorch + CUDA port of ``cleanmarl_tpu``.

The module tree mirrors the JAX package (``envs/``, ``core/``,
``buffers/``, ``ops/``, ``algos/``) so each module's counterpart is easy
to find. Ported: the seven algorithms (IPPO, MAPPO, QMIX, VDN and their
recurrent forms, MADDPG, FACMAC, COMA) and every env family (SMAClite,
MPE, the matrix game, SISL pursuit, LBF, and host PettingZoo envs through
``envs/external.py``), full-runner checkpoints (``core/checkpoint.py``),
data-parallel training over ``torch.distributed`` for all seven families
(``distributed/``), a runner for the validation recipes
(``validate.py`` over ``recipes.py``), and every optax optimizer the JAX
package trains with (``core/optim.py``, optax's arithmetic written out in
torch). Differences in idiom:

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
