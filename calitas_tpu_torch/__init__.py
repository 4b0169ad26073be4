"""calitas_tpu_torch — the PyTorch/CUDA port of calitas_tpu.

The JAX package ``calitas_tpu`` stays the reference.  This package ports
its device half to PyTorch, with the hot DP screen as a CUDA kernel
written for NVIDIA Hopper, and reuses the framework-free host half by
import (``calitas_tpu.core``, ``io``, ``align``, ``native``,
``search.hits``, ``search.windows``, ``parallel.host_pool``, ``version``).
It never imports ``jax``.

Module names mirror ``calitas_tpu`` so each counterpart is easy to find:
  - device.py                 engine / --device resolution to a torch.device
  - ops/dp_screen.py          plain PyTorch DP screen (CPU path, kernel oracle)
  - ops/dp_cuda.py            the CUDA dual-chain screen: build, wrapper, count
  - ops/genome_screen.py      staging, PAM annotation, segmented contig screen
  - parallel/screen_runner.py device screen + native host finish pipeline
  - tools/search_reference.py SearchReference reference pass
  - cli.py                    the SearchReference command line
"""

__version__ = "0.1.0"
