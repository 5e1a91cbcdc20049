"""agent_cpu_s_per_msample: the process's user and system CPU seconds
(every thread, the encode worker's too) from the interval's start to the
last counted window's completion, less the replay's own generation CPU
in that span, over the millions of samples of those windows."""


def read(run):
    counted = run.counted()
    if not counted:
        return None
    end = run.done[counted[-1]]
    gen = sum(c for t, c in run.gen_cpu if run.t_start <= t <= end)
    cpu = run.records[counted[-1]]["cpu"] - run.cpu_start - gen
    return cpu / (sum(run.samples[w] for w in counted) / 1e6)
