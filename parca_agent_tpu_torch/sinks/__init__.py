"""Pluggable output-backend sinks (docs/sinks.md).

The encode path's single hardwired pprof writer, generalized: a
SinkRegistry fans each shipped (already-prepared) window out to N
backends under a counted fail-open contract — the pprof ship is primary
and byte-identical to the pre-sink path; AutoFDO/PGO profdata-text and
scalar OTLP-style series emitters ride beside it.
"""

from parca_agent_tpu_torch.sinks.alerts import AlertsSink
from parca_agent_tpu_torch.sinks.autofdo import AutoFDOSink
from parca_agent_tpu_torch.sinks.base import Sink, SinkWindow
from parca_agent_tpu_torch.sinks.pprof import PprofSink
from parca_agent_tpu_torch.sinks.registry import SinkRegistry
from parca_agent_tpu_torch.sinks.series import SeriesSink

__all__ = [
    "AlertsSink",
    "AutoFDOSink",
    "PprofSink",
    "SeriesSink",
    "Sink",
    "SinkRegistry",
    "SinkWindow",
]
