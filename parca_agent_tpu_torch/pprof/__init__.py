"""pprof profile.proto encoding without a protobuf runtime dependency."""

from parca_agent_tpu_torch.pprof.builder import build_pprof, parse_pprof  # noqa: F401
