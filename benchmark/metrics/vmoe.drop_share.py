"""Share of V-MoE's routing assignments dropped past an expert's capacity,
in %: the ``dropped`` counts of the traced window's forward ``moe.route``
spans over their ``assignments`` (every expert of the 32, held or not)."""
from touhouimageclassification_tpu_torch.utils import profiling


def read(readings: dict):
    spans = profiling.recorded() if hasattr(profiling, "recorded") else []
    routes = [s["counts"] for s in spans if s["name"] == "moe.route"
              and "assignments" in s["counts"]]
    total = sum(c["assignments"] for c in routes)
    if not total:
        return None
    return 100.0 * sum(c["dropped"] for c in routes) / total
