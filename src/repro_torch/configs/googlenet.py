"""GoogleNet (the paper's first evaluation network) as a selectable config."""
from repro_torch.cnn.models import googlenet as build_graph


def graph(res: int = 224, scale: float = 1.0):
    return build_graph(res=res, scale=scale)
