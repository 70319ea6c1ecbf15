"""The Prometheus text exposition of a registry (counterpart of
``p2p_tpu/obs/sinks.py:154-197``), behind the HTTP server's ``GET
/metrics``: the same names, labels and lines as the JAX formatter. The
record sinks of that module come later."""

from __future__ import annotations


def _prom_name(s: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in s)
    return ("p2p_" + out) if not out or out[0].isdigit() else out


def prometheus_exposition(registry) -> str:
    """A registry's metric state in the Prometheus text format. The
    snapshot is taken first: a metric registered concurrently may appear
    in the later ``kinds()`` and is then skipped, never the reverse."""
    lines = []
    snap = sorted(registry.snapshot().items())
    kinds = registry.kinds()
    for key, fields in snap:
        if key not in kinds:
            continue
        name, _, tagpart = key.partition("{")
        labels = ""
        if tagpart:
            # registry keys carry tags as k=v,...}; the format wants the
            # label values quoted and escaped
            pairs = []
            for kv in tagpart.rstrip("}").split(","):
                k, _, v = kv.partition("=")
                v = v.replace("\\", r"\\").replace('"', r"\"")
                pairs.append(f'{_prom_name(k)}="{v}"')
            labels = "{" + ",".join(pairs) + "}"
        base = _prom_name(name)
        ptype = {"counter": "counter", "ewma": "gauge",
                 "gauge": "gauge", "histogram": "summary"}[kinds[key]]
        lines.append(f"# TYPE {base} {ptype}")
        for f, v in fields.items():
            suffix = "" if f in ("value", "rate") else "_" + _prom_name(f)
            if v != v:  # NaN gauges are left out
                continue
            lines.append(f"{base}{suffix}{labels} {v}")
    return "\n".join(lines) + "\n"
