"""parca_agent_tpu_torch — the profiler agent's device path on PyTorch and CUDA.

The window aggregation of parca_agent_tpu, held bit for bit against it,
with the device work in PyTorch on an NVIDIA card and its kernels written
by hand in CUDA C++ (csrc/). Entry points run on the CUDA card unless the
caller passes device="cpu" (CLI: --device cpu).

  capture/     window snapshot contracts, synthetic and replay sources
  aggregator/  CPUAggregator (numpy oracle), DictAggregator (device-resident
               stack dictionary), probe.py (the batch-probe kernel wrapper)
  ops/         row hashing (numpy), kernel build + load (kernels.py)
  pprof/       profile.proto encoder + parser
  agent/       local profile store
  csrc/        CUDA C++ kernel sources, built with nvcc at first use
"""

__version__ = "0.1.0"
