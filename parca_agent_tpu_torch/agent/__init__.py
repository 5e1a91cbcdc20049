"""Agent transport: batching remote write + live-query tee
(reference pkg/agent).

The port's copy of parca_agent_tpu's agent/__init__.py.
"""

from parca_agent_tpu_torch.agent.profilestore import (
    RawSeries,
    encode_write_raw_request,
    decode_write_raw_request,
)
from parca_agent_tpu_torch.agent.batch import BatchWriteClient
from parca_agent_tpu_torch.agent.listener import MatchingProfileListener
from parca_agent_tpu_torch.agent.writer import FileProfileWriter, RemoteProfileWriter

__all__ = [
    "RawSeries", "encode_write_raw_request", "decode_write_raw_request",
    "BatchWriteClient", "MatchingProfileListener",
    "FileProfileWriter", "RemoteProfileWriter",
]
