"""Share of the training steps that replayed the step's CUDA graph: the
traced window's ``trainer.step`` spans that hold a ``trainer.graph`` span
(the replay of the step's captured device half), over all its
``trainer.step`` spans, in %. Nothing where the port has no step graph
(``train/step_graph.py``)."""
import importlib.util

from touhouimageclassification_tpu_torch.utils import profiling

GRAPH_MODULE = "touhouimageclassification_tpu_torch.train.step_graph"


def read(readings: dict):
    if importlib.util.find_spec(GRAPH_MODULE) is None:
        return None
    spans = profiling.recorded() if hasattr(profiling, "recorded") else []
    steps = [i for i, s in enumerate(spans) if s["name"] == "trainer.step"]
    if not steps:
        return None
    graphed = {s["parent"] for s in spans if s["name"] == "trainer.graph"}
    return 100.0 * sum(i in graphed for i in steps) / len(steps)
