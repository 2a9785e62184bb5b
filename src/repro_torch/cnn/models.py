"""CNN model-graph builders: GoogleNet, Inception-v4 (the paper's two
evaluation networks), plus VGG-16 / ResNet-18 / AlexNet (Lemma 4.3 coverage).

All builders emit ``repro_torch.core.graph.Graph`` with ConvMeta per conv vertex
and ``out_shape`` annotations on every non-conv vertex so the mapper can
price transitions. A ``scale`` factor shrinks spatial dims and channels for
CPU-runnable smoke configurations while preserving graph topology.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.graph import ConvMeta, Graph, LayerKind


def _c(x: float, scale: float, minimum: int = 1) -> int:
    return max(minimum, int(round(x * scale)))


@dataclasses.dataclass
class _Cursor:
    """Tracks the frontier node and its (H, W, C) while chaining layers."""
    g: Graph
    node: int
    h: int
    w: int
    c: int

    def conv(self, c_out: int, k1: int, k2: int, stride: int = 1,
             pad: str = "same", name: str = "") -> "_Cursor":
        meta = ConvMeta(c_in=self.c, c_out=c_out, h1=self.h, h2=self.w,
                        k1=k1, k2=k2, stride=stride, pad=pad)
        nid = self.g.add_node(LayerKind.CONV, name=name, conv=meta)
        self.g.add_edge(self.node, nid)
        return _Cursor(self.g, nid, meta.o1, meta.o2, c_out)

    def pool(self, k: int, stride: int, kind: LayerKind = LayerKind.POOL_MAX,
             pad: str = "same", name: str = "") -> "_Cursor":
        if pad == "same":
            oh, ow = -(-self.h // stride), -(-self.w // stride)
        else:
            oh = (self.h - k) // stride + 1
            ow = (self.w - k) // stride + 1
        nid = self.g.add_node(kind, name=name, out_shape=(oh, ow, self.c),
                              k=k, stride=stride, pad=pad)
        self.g.add_edge(self.node, nid)
        return _Cursor(self.g, nid, oh, ow, self.c)

    def global_pool(self, name: str = "gap") -> "_Cursor":
        nid = self.g.add_node(LayerKind.GLOBAL_POOL, name=name,
                              out_shape=(1, 1, self.c))
        self.g.add_edge(self.node, nid)
        return _Cursor(self.g, nid, 1, 1, self.c)

    def fc(self, out_features: int, name: str = "fc") -> "_Cursor":
        nid = self.g.add_node(LayerKind.FC, name=name,
                              out_shape=(1, 1, out_features),
                              in_features=self.h * self.w * self.c,
                              out_features=out_features)
        self.g.add_edge(self.node, nid)
        return _Cursor(self.g, nid, 1, 1, out_features)


def _concat(g: Graph, branches: Sequence[_Cursor], name: str) -> _Cursor:
    h, w = branches[0].h, branches[0].w
    for b in branches:
        assert (b.h, b.w) == (h, w), \
            f"{name}: branch shapes differ: {[(b.h, b.w, b.c) for b in branches]}"
    c = sum(b.c for b in branches)
    nid = g.add_node(LayerKind.CONCAT, name=name, out_shape=(h, w, c))
    for b in branches:
        g.add_edge(b.node, nid)
    return _Cursor(g, nid, h, w, c)


def _add(g: Graph, a: _Cursor, b: _Cursor, name: str) -> _Cursor:
    assert (a.h, a.w, a.c) == (b.h, b.w, b.c)
    nid = g.add_node(LayerKind.ADD, name=name, out_shape=(a.h, a.w, a.c))
    g.add_edge(a.node, nid)
    g.add_edge(b.node, nid)
    return _Cursor(g, nid, a.h, a.w, a.c)


def _start(res: int, c_in: int = 3) -> Tuple[Graph, _Cursor]:
    g = Graph()
    nid = g.add_node(LayerKind.INPUT, name="input", out_shape=(res, res, c_in))
    return g, _Cursor(g, nid, res, res, c_in)


def _finish(cur: _Cursor, classes: int) -> Graph:
    cur = cur.global_pool().fc(classes)
    out = cur.g.add_node(LayerKind.OUTPUT, name="output",
                         out_shape=(1, 1, classes))
    cur.g.add_edge(cur.node, out)
    return cur.g


# ---------------------------------------------------------------------------
# GoogleNet (Inception-v1) — Szegedy et al. 2015, Table 1.
# ---------------------------------------------------------------------------

def _inception_v1(cur: _Cursor, n1: int, r3: int, n3: int, r5: int, n5: int,
                  pp: int, name: str) -> _Cursor:
    g = cur.g
    b1 = cur.conv(n1, 1, 1, name=f"{name}/1x1")
    b2 = cur.conv(r3, 1, 1, name=f"{name}/3x3r").conv(n3, 3, 3,
                                                      name=f"{name}/3x3")
    b3 = cur.conv(r5, 1, 1, name=f"{name}/5x5r").conv(n5, 5, 5,
                                                      name=f"{name}/5x5")
    b4 = cur.pool(3, 1, name=f"{name}/pool").conv(pp, 1, 1,
                                                  name=f"{name}/poolproj")
    return _concat(g, [b1, b2, b3, b4], f"{name}/concat")


def googlenet(res: int = 224, classes: int = 1000,
              scale: float = 1.0) -> Graph:
    s = scale
    g, cur = _start(res)
    cur = cur.conv(_c(64, s), 7, 7, stride=2, name="conv1")
    cur = cur.pool(3, 2, name="pool1")
    cur = cur.conv(_c(64, s), 1, 1, name="conv2r")
    cur = cur.conv(_c(192, s), 3, 3, name="conv2")
    cur = cur.pool(3, 2, name="pool2")
    cfg = [
        ("3a", 64, 96, 128, 16, 32, 32), ("3b", 128, 128, 192, 32, 96, 64),
        ("pool", 0, 0, 0, 0, 0, 0),
        ("4a", 192, 96, 208, 16, 48, 64), ("4b", 160, 112, 224, 24, 64, 64),
        ("4c", 128, 128, 256, 24, 64, 64), ("4d", 112, 144, 288, 32, 64, 64),
        ("4e", 256, 160, 320, 32, 128, 128),
        ("pool", 0, 0, 0, 0, 0, 0),
        ("5a", 256, 160, 320, 32, 128, 128),
        ("5b", 384, 192, 384, 48, 128, 128),
    ]
    for row in cfg:
        if row[0] == "pool":
            cur = cur.pool(3, 2, name="pool")
        else:
            name, n1, r3, n3, r5, n5, pp = row
            cur = _inception_v1(cur, _c(n1, s), _c(r3, s), _c(n3, s),
                                _c(r5, s), _c(n5, s), _c(pp, s),
                                f"inception_{name}")
    return _finish(cur, classes)


# ---------------------------------------------------------------------------
# Inception-v4 — Szegedy et al. 2016 (Figures 3-9).
# ---------------------------------------------------------------------------

def _stem_v4(cur: _Cursor, s: float) -> _Cursor:
    g = cur.g
    cur = cur.conv(_c(32, s), 3, 3, stride=2, pad="valid", name="stem/c1")
    cur = cur.conv(_c(32, s), 3, 3, pad="valid", name="stem/c2")
    cur = cur.conv(_c(64, s), 3, 3, name="stem/c3")
    p = cur.pool(3, 2, pad="valid", name="stem/p1")
    c = cur.conv(_c(96, s), 3, 3, stride=2, pad="valid", name="stem/c4")
    cur = _concat(g, [p, c], "stem/cat1")
    a = cur.conv(_c(64, s), 1, 1, name="stem/a1").conv(
        _c(96, s), 3, 3, pad="valid", name="stem/a2")
    b = (cur.conv(_c(64, s), 1, 1, name="stem/b1")
         .conv(_c(64, s), 7, 1, name="stem/b2")
         .conv(_c(64, s), 1, 7, name="stem/b3")
         .conv(_c(96, s), 3, 3, pad="valid", name="stem/b4"))
    cur = _concat(g, [a, b], "stem/cat2")
    c2 = cur.conv(_c(192, s), 3, 3, stride=2, pad="valid", name="stem/c5")
    p2 = cur.pool(3, 2, pad="valid", name="stem/p2")
    return _concat(g, [c2, p2], "stem/cat3")


def _inception_a(cur: _Cursor, s: float, name: str) -> _Cursor:
    g = cur.g
    b1 = cur.pool(3, 1, kind=LayerKind.POOL_AVG, name=f"{name}/ap").conv(
        _c(96, s), 1, 1, name=f"{name}/b1")
    b2 = cur.conv(_c(96, s), 1, 1, name=f"{name}/b2")
    b3 = cur.conv(_c(64, s), 1, 1, name=f"{name}/b3a").conv(
        _c(96, s), 3, 3, name=f"{name}/b3b")
    b4 = (cur.conv(_c(64, s), 1, 1, name=f"{name}/b4a")
          .conv(_c(96, s), 3, 3, name=f"{name}/b4b")
          .conv(_c(96, s), 3, 3, name=f"{name}/b4c"))
    return _concat(g, [b1, b2, b3, b4], f"{name}/cat")


def _reduction_a(cur: _Cursor, s: float, name: str = "redA") -> _Cursor:
    g = cur.g
    b1 = cur.pool(3, 2, pad="valid", name=f"{name}/mp")
    b2 = cur.conv(_c(384, s), 3, 3, stride=2, pad="valid", name=f"{name}/b2")
    b3 = (cur.conv(_c(192, s), 1, 1, name=f"{name}/b3a")
          .conv(_c(224, s), 3, 3, name=f"{name}/b3b")
          .conv(_c(256, s), 3, 3, stride=2, pad="valid", name=f"{name}/b3c"))
    return _concat(g, [b1, b2, b3], f"{name}/cat")


def _inception_b(cur: _Cursor, s: float, name: str) -> _Cursor:
    g = cur.g
    b1 = cur.pool(3, 1, kind=LayerKind.POOL_AVG, name=f"{name}/ap").conv(
        _c(128, s), 1, 1, name=f"{name}/b1")
    b2 = cur.conv(_c(384, s), 1, 1, name=f"{name}/b2")
    b3 = (cur.conv(_c(192, s), 1, 1, name=f"{name}/b3a")
          .conv(_c(224, s), 1, 7, name=f"{name}/b3b")
          .conv(_c(256, s), 7, 1, name=f"{name}/b3c"))
    b4 = (cur.conv(_c(192, s), 1, 1, name=f"{name}/b4a")
          .conv(_c(192, s), 7, 1, name=f"{name}/b4b")
          .conv(_c(224, s), 1, 7, name=f"{name}/b4c")
          .conv(_c(224, s), 7, 1, name=f"{name}/b4d")
          .conv(_c(256, s), 1, 7, name=f"{name}/b4e"))
    return _concat(g, [b1, b2, b3, b4], f"{name}/cat")


def _reduction_b(cur: _Cursor, s: float, name: str = "redB") -> _Cursor:
    g = cur.g
    b1 = cur.pool(3, 2, pad="valid", name=f"{name}/mp")
    b2 = cur.conv(_c(192, s), 1, 1, name=f"{name}/b2a").conv(
        _c(192, s), 3, 3, stride=2, pad="valid", name=f"{name}/b2b")
    b3 = (cur.conv(_c(256, s), 1, 1, name=f"{name}/b3a")
          .conv(_c(256, s), 1, 7, name=f"{name}/b3b")
          .conv(_c(320, s), 7, 1, name=f"{name}/b3c")
          .conv(_c(320, s), 3, 3, stride=2, pad="valid", name=f"{name}/b3d"))
    return _concat(g, [b1, b2, b3], f"{name}/cat")


def _inception_c(cur: _Cursor, s: float, name: str) -> _Cursor:
    g = cur.g
    b1 = cur.pool(3, 1, kind=LayerKind.POOL_AVG, name=f"{name}/ap").conv(
        _c(256, s), 1, 1, name=f"{name}/b1")
    b2 = cur.conv(_c(256, s), 1, 1, name=f"{name}/b2")
    # Branch 3: the 1x1 output *splits* into two parallel convs (out-degree
    # 2 → a store-format vertex in the cost graph).
    b3 = cur.conv(_c(384, s), 1, 1, name=f"{name}/b3a")
    b3l = b3.conv(_c(256, s), 1, 3, name=f"{name}/b3b")
    b3r = b3.conv(_c(256, s), 3, 1, name=f"{name}/b3c")
    b4 = (cur.conv(_c(384, s), 1, 1, name=f"{name}/b4a")
          .conv(_c(448, s), 1, 3, name=f"{name}/b4b")
          .conv(_c(512, s), 3, 1, name=f"{name}/b4c"))
    b4l = b4.conv(_c(256, s), 3, 1, name=f"{name}/b4d")
    b4r = b4.conv(_c(256, s), 1, 3, name=f"{name}/b4e")
    return _concat(g, [b1, b2, b3l, b3r, b4l, b4r], f"{name}/cat")


def inception_v4(res: int = 299, classes: int = 1000, scale: float = 1.0,
                 n_a: int = 4, n_b: int = 7, n_c: int = 3) -> Graph:
    s = scale
    g, cur = _start(res)
    cur = _stem_v4(cur, s)
    for i in range(n_a):
        cur = _inception_a(cur, s, f"incA{i}")
    cur = _reduction_a(cur, s)
    for i in range(n_b):
        cur = _inception_b(cur, s, f"incB{i}")
    cur = _reduction_b(cur, s)
    for i in range(n_c):
        cur = _inception_c(cur, s, f"incC{i}")
    return _finish(cur, classes)


# ---------------------------------------------------------------------------
# Chain / residual networks (Lemma 4.3).
# ---------------------------------------------------------------------------

def vgg16(res: int = 224, classes: int = 1000, scale: float = 1.0) -> Graph:
    s = scale
    g, cur = _start(res)
    for block, (n, reps) in enumerate([(64, 2), (128, 2), (256, 3),
                                       (512, 3), (512, 3)]):
        for i in range(reps):
            cur = cur.conv(_c(n, s), 3, 3, name=f"conv{block}_{i}")
        cur = cur.pool(2, 2, name=f"pool{block}")
    return _finish(cur, classes)


def alexnet(res: int = 224, classes: int = 1000, scale: float = 1.0) -> Graph:
    s = scale
    g, cur = _start(res)
    cur = cur.conv(_c(64, s), 11, 11, stride=4, name="conv1").pool(3, 2)
    cur = cur.conv(_c(192, s), 5, 5, name="conv2").pool(3, 2)
    cur = cur.conv(_c(384, s), 3, 3, name="conv3")
    cur = cur.conv(_c(256, s), 3, 3, name="conv4")
    cur = cur.conv(_c(256, s), 3, 3, name="conv5").pool(3, 2)
    return _finish(cur, classes)


def resnet18(res: int = 224, classes: int = 1000, scale: float = 1.0) -> Graph:
    s = scale
    g, cur = _start(res)
    cur = cur.conv(_c(64, s), 7, 7, stride=2, name="conv1").pool(3, 2)
    chans = [(64, 1), (64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
             (512, 2), (512, 1)]
    for i, (c, stride) in enumerate(chans):
        c_ = _c(c, s)
        main = cur.conv(c_, 3, 3, stride=stride, name=f"res{i}a")
        main = main.conv(c_, 3, 3, name=f"res{i}b")
        if stride != 1 or cur.c != c_:
            skip = cur.conv(c_, 1, 1, stride=stride, name=f"res{i}s")
        else:
            skip = cur
        cur = _add(g, main, skip, f"res{i}add")
    return _finish(cur, classes)


MODELS = {
    "googlenet": googlenet,
    "inception_v4": inception_v4,
    "vgg16": vgg16,
    "alexnet": alexnet,
    "resnet18": resnet18,
}
