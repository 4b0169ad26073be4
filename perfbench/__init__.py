"""The benchmark of the PyTorch/CUDA port (``calitas_tpu_torch``): whole-genome
searches through ``serve.ResidentSearcher.search``.  Run it as
``python3 perfbench/run.py --workload CELL --seed N --seconds S --trace 0|1``
from the root of a checkout; ``BENCHMARK.json`` names the cells."""
