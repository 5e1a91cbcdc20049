"""Label production: metadata merge + Prometheus relabeling
(reference pkg/metadata/labels).

The port's copy of parca_agent_tpu's labels/__init__.py.
"""

from parca_agent_tpu_torch.labels.relabel import RelabelConfig, process as relabel_process
from parca_agent_tpu_torch.labels.manager import LabelsManager

__all__ = ["RelabelConfig", "relabel_process", "LabelsManager"]
