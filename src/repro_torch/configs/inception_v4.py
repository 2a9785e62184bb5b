"""Inception-v4 (the paper's second evaluation network) as a config."""
from repro_torch.cnn.models import inception_v4 as build_graph


def graph(res: int = 299, scale: float = 1.0):
    return build_graph(res=res, scale=scale)
