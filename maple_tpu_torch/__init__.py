"""maple-tpu-torch: the maple_tpu device path in PyTorch and CUDA.

A second package beside :mod:`maple_tpu`, for one NVIDIA Hopper card.  It
shares every jax-free module of :mod:`maple_tpu` (I/O, host kernels, tree
runtime, search, models, the native C++ engine, the pipeline's host
stages) and re-writes only what imports jax:

- :mod:`maple_tpu_torch.ops`: the stacked entry layout, the device model
  and the appendProbNode pair kernel (CUDA C++ in ``csrc/``, built with
  ``nvcc`` at first use),
- :mod:`maple_tpu_torch.parallel`: the pipelined device placer and the
  device SPR screen,
- :mod:`maple_tpu_torch.search`: the SPR rounds loop that reaches it,
- :mod:`maple_tpu_torch.pipeline` and :mod:`maple_tpu_torch.cli`: the
  ``--devicePlacement`` and ``--deviceTopology`` entry point on an
  explicit ``torch.device``.

This package never imports jax.
"""

__version__ = "0.1.0"
