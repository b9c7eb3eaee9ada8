"""graph_nodes_per_step.hybrid: kernel nodes of the captured train step's
CUDA graph on the hybrid solver (``StepGraph.stats()["kernel_nodes"]``)."""

PREFIX = "train step"


def read(run):
    nodes = [g["kernel_nodes"] for g in run.graphs
             if g and g["name"].startswith(PREFIX) and g["kernel_nodes"]]
    return max(nodes) if nodes else None
