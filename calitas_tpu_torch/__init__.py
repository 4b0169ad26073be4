"""calitas_tpu_torch — the PyTorch/CUDA port of calitas_tpu.

The JAX package ``calitas_tpu`` stays the reference.  This package stands
alone: it ports the device half to PyTorch, with the DP screens as CUDA
kernels written for NVIDIA Hopper, and carries its own copy of the
framework-free host half (core, io, align, native, search, the finish
pool, the host passes, PrepareVcf, version).  It imports neither ``jax``
nor ``calitas_tpu``.  The host modules import no torch, so the finish
pool's spawned workers start without it.

Module names mirror ``calitas_tpu`` so each counterpart is easy to find.
The host half, copied from it (imports renamed; ``LazyCigar`` pickles,
``align.engine.NO_SCREEN`` holds the pair screen's sentinel):
  - version.py, utils.py      version stamp, progress logging
  - core/                     sequence encoding, cigar, scoring, guide
  - io/                       FASTA (.fai/.dict), VCF, BGZF, TSV
  - native/                   the C++ host finish, built with g++ at first use
  - align/                    oracle, engine, batched native finish
  - search/                   windows, hits, the variant window builder
  - parallel/host_pool.py     the finish worker pool
  - tools/prepare_vcf.py      PrepareVcf
  - goldens.py                inputs of the golden configurations
The device half:
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
  - ops/probes.py             the roofline probes (CUDA) and roofline()
  - search/variants.py        device screen of variant windows
  - tools/search_reference.py SearchReference: both engines' passes
  - tools/pairwise.py         PairwiseAlignSequences
  - tools/align_to_reference.py AlignToReference (best and all-hits modes)
  - cli.py                    the command line of the four tools
"""

__version__ = "0.1.0"
