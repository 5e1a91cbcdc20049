"""Multi-tenant admission: the tenant identity.

The pure head of parca_agent_tpu's runtime/admission.py: the tenant
label, the selector validator the HTTP read path shares, and the tenant
a cgroup path names. The resolver, the overload policy and the admission
controller are not in this package yet.
"""

from __future__ import annotations

import re

# The label key the tenant provider attaches and the /query `tenant=`
# selector shorthand expands to: one identity from cgroup to read path.
TENANT_LABEL = "tenant"

# Tenant ids are derived from cgroup paths but travel as metric labels
# and HTTP selector values; the validator is the shared gate.
_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._:@/-]{0,127}$")

UNKNOWN_TENANT = "unknown"


def validate_tenant(value: str) -> str:
    """A well-formed tenant selector value, or ValueError (the HTTP
    handlers turn it into a 400)."""
    if not isinstance(value, str) or not _TENANT_RE.match(value):
        raise ValueError(f"malformed tenant value {str(value)[:64]!r}")
    return value


_POD_RE = re.compile(r"pod([0-9a-fA-F][0-9a-fA-F_-]{7,63})")
_CTR_RE = re.compile(r"(?:docker|cri-containerd|crio)[/:-]([0-9a-f]{12,64})")
_USER_RE = re.compile(r"/user\.slice/user-(\d+)\.slice")


def tenant_from_cgroup(path: str | None) -> str:
    """Tenant identity out of a primary cgroup path. Recognized shapes,
    most specific first: kube pod uid, container id, user slice, systemd
    unit, else the first path component; root/empty is "system". The
    result always passes validate_tenant (hostile path bytes collapse
    to the unknown tenant rather than poisoning a metric label)."""
    if not path or path == "/":
        return "system"
    m = _POD_RE.search(path)
    if m:
        tenant = "pod:" + m.group(1).replace("_", "-").lower()
    else:
        m = _CTR_RE.search(path)
        if m:
            tenant = "ctr:" + m.group(1)[:12]
        else:
            m = _USER_RE.search(path)
            if m:
                tenant = "user:" + m.group(1)
            else:
                unit = None
                for comp in path.split("/"):
                    if comp:
                        unit = comp
                        if comp != "system.slice":
                            break
                if unit is None:
                    return "system"
                tenant = ("svc:" + unit if unit.endswith(
                    (".service", ".scope", ".slice")) else "grp:" + unit)
    try:
        return validate_tenant(tenant)
    except ValueError:
        return UNKNOWN_TENANT
