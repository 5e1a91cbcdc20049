"""Inspect a pprof profile the agent wrote (.pb or .pb.gz).

The port's copy of parca_agent_tpu/tools/pprof_dump.py (the same text
for the same file). Dev tool in the spirit of tools/snapshot.py: makes
the OUTPUT artifact a thing you can look at without a Parca server —
header metadata, totals, and the top stacks by self count, decoded
through the same parser the tests trust (pprof/builder.parse_pprof).

Run: python -m parca_agent_tpu_torch.tools.pprof_dump FILE [--top N]
"""

from __future__ import annotations

import argparse
import gzip

from parca_agent_tpu_torch.pprof.builder import ParsedProfile, parse_pprof


def format_profile(p: ParsedProfile, top: int = 10) -> str:
    total = sum(v[0] for _, v, _ in p.samples)
    lines = [
        f"sample_types: {p.sample_types}",
        f"period: {p.period} {p.period_type[1]} ({p.period_type[0]})",
        f"time_nanos: {p.time_nanos}  duration_nanos: {p.duration_nanos}",
        f"samples: {len(p.samples)} rows, {total} total",
        f"locations: {len(p.locations)}  mappings: {len(p.mappings)}  "
        f"functions: {len(p.functions)}  strings: {len(p.strings)}",
    ]
    if p.mappings:
        shown = sorted(p.mappings)[:8]
        more = (f" (+{len(p.mappings) - len(shown)} more)"
                if len(p.mappings) > len(shown) else "")
        lines.append(f"mappings:{more}")
        for mid in shown:
            m = p.mappings[mid]
            lines.append(
                f"  #{mid} {m['start']:#x}-{m['limit']:#x} "
                f"off={m['offset']:#x} {m['filename'] or '?'} "
                f"build_id={m['build_id'][:16] or '-'}")
    ranked = sorted(p.samples, key=lambda s: -s[1][0])[:top]
    lines.append(f"top {len(ranked)} stacks:")
    for loc_ids, vals, labels in ranked:
        frames = []
        for lid in loc_ids[:6]:
            loc = p.locations.get(lid)
            if loc is None:
                frames.append("?")
                continue
            if loc["lines"]:
                fid = loc["lines"][0][0]
                fn = p.functions.get(fid, {}).get("name", "")
                frames.append(fn or f"{loc['address']:#x}")
            else:
                frames.append(f"{loc['address']:#x}")
        more = f" ... +{len(loc_ids) - 6}" if len(loc_ids) > 6 else ""
        lab = f"  {labels}" if labels else ""
        lines.append(f"  {vals[0]:>8}  {' ; '.join(frames)}{more}{lab}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pprof-dump", description=__doc__.splitlines()[0])
    ap.add_argument("file")
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)
    with open(args.file, "rb") as f:
        data = f.read()
    # parse_pprof sniffs one gzip layer itself; peel any extras here
    # (files written before the double-gzip fix carry two layers).
    while data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    try:
        print(format_profile(parse_pprof(data), top=args.top))
    except BrokenPipeError:
        pass  # piped into head; normal CLI etiquette
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
