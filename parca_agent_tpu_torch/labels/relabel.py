"""Prometheus relabel_configs semantics.

The reference delegates to prometheus/prometheus's relabel package
(pkg/metadata/labels/manager.go:135-162; config schema pkg/config/
config.go:25-27). This is a from-scratch implementation of the same
documented semantics so relabel rules users already run against
parca-agent behave identically here: actions replace, keep, drop,
keepequal, dropequal, hashmod, labelmap, labeldrop, labelkeep, lowercase,
uppercase; full-string-anchored regexes; $N/${N} replacement expansion;
dropping a target label by producing an empty value.

process() returns None when the label set is dropped — the signal the
labels manager uses to skip profiling a target (manager.go:135-162 returns
nil on drop).

The port's copy of parca_agent_tpu's labels/relabel.py.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re


@dataclasses.dataclass
class RelabelConfig:
    action: str = "replace"
    source_labels: tuple[str, ...] = ()
    separator: str = ";"
    target_label: str = ""
    regex: str = "(.*)"
    modulus: int = 0
    replacement: str = "$1"

    _compiled: re.Pattern = dataclasses.field(init=False, repr=False)

    _ACTIONS = frozenset({
        "replace", "keep", "drop", "keepequal", "dropequal", "hashmod",
        "labelmap", "labeldrop", "labelkeep", "lowercase", "uppercase",
    })

    def __post_init__(self):
        self.action = self.action.lower()
        if self.action not in self._ACTIONS:
            raise ValueError(f"unknown relabel action {self.action!r}")
        # Prometheus anchors the regex at both ends.
        self._compiled = re.compile(f"^(?:{self.regex})$")
        if self.action in ("replace", "hashmod", "lowercase", "uppercase") \
                and not self.target_label:
            raise ValueError(f"relabel action {self.action} needs target_label")
        if self.action == "hashmod" and self.modulus <= 0:
            raise ValueError("hashmod needs a positive modulus")

    @classmethod
    def from_dict(cls, d: dict) -> "RelabelConfig":
        return cls(
            action=d.get("action", "replace"),
            source_labels=tuple(d.get("source_labels", ())),
            separator=d.get("separator", ";"),
            target_label=d.get("target_label", ""),
            regex=str(d.get("regex", "(.*)")),
            modulus=int(d.get("modulus", 0)),
            replacement=d.get("replacement", "$1"),
        )


def _expand(template: str, m: re.Match) -> str:
    """Expand $1 / ${1} / $name the way Prometheus (Go regexp Expand) does:
    unknown groups expand to empty, $$ is a literal $."""
    out = []
    i = 0
    n = len(template)
    while i < n:
        c = template[i]
        if c != "$":
            out.append(c)
            i += 1
            continue
        if i + 1 < n and template[i + 1] == "$":
            out.append("$")
            i += 2
            continue
        j = i + 1
        braced = j < n and template[j] == "{"
        if braced:
            j += 1
        start = j
        while j < n and (template[j].isalnum() or template[j] == "_"):
            j += 1
        name = template[start:j]
        if braced:
            if j < n and template[j] == "}":
                j += 1
            else:  # unterminated brace: literal
                out.append(template[i:j])
                i = j
                continue
        if not name:
            out.append("$")
            i += 1
            continue
        try:
            val = m.group(int(name)) if name.isdigit() else m.group(name)
        except (IndexError, re.error):  # unknown group -> ""
            val = ""
        out.append(val or "")
        i = j
    return "".join(out)


def relabel_one(labels: dict[str, str], cfg: RelabelConfig) -> dict[str, str] | None:
    src = cfg.separator.join(labels.get(name, "") for name in cfg.source_labels)
    act = cfg.action

    if act == "drop":
        return None if cfg._compiled.match(src) else labels
    if act == "keep":
        return labels if cfg._compiled.match(src) else None
    if act == "dropequal":
        return None if labels.get(cfg.target_label, "") == src else labels
    if act == "keepequal":
        return labels if labels.get(cfg.target_label, "") == src else None
    if act == "replace":
        m = cfg._compiled.match(src)
        if m is None:
            return labels
        target = _expand(cfg.target_label, m) if "$" in cfg.target_label \
            else cfg.target_label
        value = _expand(cfg.replacement, m)
        out = dict(labels)
        if not target:
            return labels
        if value == "":
            out.pop(target, None)
        else:
            out[target] = value
        return out
    if act == "hashmod":
        h = int.from_bytes(hashlib.md5(src.encode()).digest()[-8:], "big")
        out = dict(labels)
        out[cfg.target_label] = str(h % cfg.modulus)
        return out
    if act == "labelmap":
        out = dict(labels)
        for name, value in labels.items():
            m = cfg._compiled.match(name)
            if m is not None:
                new_name = _expand(cfg.replacement, m)
                if new_name:
                    out[new_name] = value
        return out
    if act == "labeldrop":
        return {k: v for k, v in labels.items() if not cfg._compiled.match(k)}
    if act == "labelkeep":
        return {k: v for k, v in labels.items() if cfg._compiled.match(k)}
    if act in ("lowercase", "uppercase"):
        out = dict(labels)
        out[cfg.target_label] = src.lower() if act == "lowercase" else src.upper()
        return out
    raise ValueError(f"unknown relabel action {act!r}")


def process(labels: dict[str, str],
            configs: list[RelabelConfig]) -> dict[str, str] | None:
    """Apply configs in order; None means the target is dropped."""
    for cfg in configs:
        labels = relabel_one(labels, cfg)
        if labels is None:
            return None
    return labels
