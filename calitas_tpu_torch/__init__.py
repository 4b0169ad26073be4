"""calitas_tpu_torch — the PyTorch/CUDA port of calitas_tpu.

The JAX package ``calitas_tpu`` stays the reference.  This package ports
its device half to PyTorch, with the hot DP screen as a CUDA kernel
written for NVIDIA Hopper, and reuses the framework-free host half by
import (``calitas_tpu.core``, ``io``, ``align``, ``native``,
``search.hits``, ``search.windows``, the variant window builder of
``search.variants``, ``parallel.host_pool``, ``tools.prepare_vcf``,
``version``).
It never imports ``jax``.

Module names mirror ``calitas_tpu`` so each counterpart is easy to find:
  - device.py                 engine / --device resolution to a torch.device
  - ops/dp_screen.py          plain PyTorch DP screens (CPU path, plain route
                              of long queries, kernel oracles), ScreenKernel
  - ops/dp_cuda.py            the CUDA screens (dual-chain, multi-guide, row):
                              build, wrappers, launch counters, the static
                              kernel/plain route, CudaScreenKernel
  - ops/genome_screen.py      staging, PAM annotation, segmented contig
                              screens (one guide or a group), slot screen
  - ops/pair_screen.py        PairScreen: (query, target) rows, both chains
  - parallel/screen_runner.py device screen + native host finish pipeline
  - search/variants.py        device screen of variant windows
  - tools/search_reference.py SearchReference: reference and variant passes
  - tools/pairwise.py         PairwiseAlignSequences
  - tools/align_to_reference.py AlignToReference (best and all-hits modes)
  - cli.py                    the command line of the four tools
"""

__version__ = "0.1.0"
