"""maple-tpu-torch: maple_tpu in PyTorch and CUDA, for one NVIDIA Hopper card.

A package of its own beside :mod:`maple_tpu`: it imports torch, never jax,
and nothing of :mod:`maple_tpu`.

- Host modules are copies of maple_tpu's jax-free ones under the same
  names (``config``, ``refdata``, ``io``, ``core``, ``runtime``, ``search``,
  ``models``, ``analysis``, ``native``, ``ops.pack``); the tests hold each
  copy to its twin.  :mod:`maple_tpu_torch.native.bridge` builds its own
  library from ``native/maple_native.cpp`` into ``_build/``.
- :mod:`maple_tpu_torch.ops`: the stacked entry layout, the device model
  and the appendProbNode pair kernel (CUDA C++ in ``csrc/``, built with
  ``nvcc`` at first use).
- :mod:`maple_tpu_torch.parallel`: the device placers (proxy screen,
  pipelined, legacy batch) and the device SPR screen.
- :mod:`maple_tpu_torch.pipeline` and :mod:`maple_tpu_torch.cli`: the
  pipeline with ``--devicePlacement`` and ``--deviceTopology`` on an
  explicit ``torch.device``.
"""

__version__ = "0.1.0"
