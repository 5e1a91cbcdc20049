"""The benchmark of parca_agent_tpu_torch: one command runs one cell.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` prints one JSON result line (BENCHMARK.json names the
cells). Every module here is plain Python and NumPy apart from the
harness's calls into the port; none imports JAX or parca_agent_tpu.
"""

import os

# One thread in each math library's pool, as an agent with a small CPU
# share runs: the default pools (a thread a core) spin beside the capture
# thread and the encode worker, cost the firehose ~15% more CPU a sample
# and made runs of one seed differ by as much.
THREAD_POOLS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def one_thread_pools() -> None:
    """Fix every pool at one thread; call before numpy or torch loads."""
    for var in THREAD_POOLS:
        os.environ[var] = "1"
