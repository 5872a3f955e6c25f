"""gadget_leicester_tpu_torch — the PyTorch and CUDA port of
gadget_leicester_tpu.

The JAX package beside it is the reference; this package mirrors its
layout (``core/``, ``ops/``, ``models/``, ``parallel/``) and names each
module's JAX counterpart in its docstring. The first slice ported is the lcdm_gas
sync-point step: periodic TreePM gravity and block-packed SPH, driven by
``models.simulation.Simulation``. Its four hand-written CUDA kernels live
in ``csrc/`` and are built and bound by ``kernels.py``; every kernel has a
plain PyTorch version that runs when its inputs are on the CPU.

This package imports torch and never jax.
"""

__version__ = "0.1.0"

from gadget_leicester_tpu_torch.core.config import (SimConfig, SimOptions,
                                                    read_parameter_file)

__all__ = ["SimConfig", "SimOptions", "read_parameter_file", "__version__"]
