"""carry_hit_pct: the rows the carry cache matched over the rows handed to
it in the measured interval (the aggregator's carry_hits and
carry_rows_in counters), in percent."""


def read(run):
    a, b = run.counters_start, run.counters_end
    rows = b["carry_rows_in"] - a["carry_rows_in"]
    if rows <= 0:
        return None
    return (b["carry_hits"] - a["carry_hits"]) / rows * 100.0
