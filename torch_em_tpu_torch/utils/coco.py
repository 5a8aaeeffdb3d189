"""COCO annotations and masks in numpy, with no pycocotools.

A port of pycocotools' ``maskApi.c`` (``rleDecode``, ``rleMerge``, ``rleFrPoly``, ``rleFrBbox``,
``rleToString`` and ``rleFrString``) and of the parts of ``mask.py`` and ``coco.py`` that the dataset
readers call: ``frPyObjects``, ``merge``, ``decode`` and the ``COCO`` index with ``getImgIds``,
``getAnnIds``, ``loadImgs``, ``loadAnns``, ``annToRLE`` and ``annToMask``.
A mask is ``uint8`` of shape (h, w); an RLE object is ``{"size": [h, w], "counts": bytes}`` with the
counts compressed as pycocotools compresses them (column-major runs, starting with zeros).

``rleFrPoly`` follows maskApi step by step: the vertices scaled by 5 and rounded (C's truncating
cast of ``x + 0.5``), the boundary traced densely between them, the points where the traced x
changes kept and mapped back, and the column-major transitions sorted into run lengths.
"""

import itertools
import json
import os
from collections import defaultdict
from typing import Dict, List, Sequence, Union

import numpy as np

__all__ = ["COCO", "frPyObjects", "merge", "decode", "rle_from_string", "rle_to_string"]


def rle_from_string(counts: Union[str, bytes]) -> np.ndarray:
    """The run lengths of a compressed counts string (maskApi's ``rleFrString``): 5 bits a character offset by
    48, 0x20 the continuation bit, 0x10 the sign bit of the last character; from the fourth count on, each adds
    the count two before it."""
    if isinstance(counts, str):
        counts = counts.encode("ascii")
    runs, x, k = [], 0, 0
    for char in counts:
        c = char - 48
        x |= (c & 0x1F) << (5 * k)
        k += 1
        if c & 0x20:
            continue
        if c & 0x10:
            x |= -1 << (5 * k)
        if len(runs) > 2:
            x += runs[-2]
        runs.append(x & 0xFFFFFFFF)  # maskApi stores the counts as uint
        x, k = 0, 0
    return np.asarray(runs, dtype=np.uint32)


def rle_to_string(runs: Sequence[int]) -> bytes:
    """The compressed counts string of run lengths (maskApi's ``rleToString``)."""
    out = bytearray()
    runs = [int(r) for r in runs]
    for i, run in enumerate(runs):
        x = run - runs[i - 2] if i > 2 else run
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def _runs(rle: Dict) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        return rle_from_string(counts)
    return np.asarray(counts, dtype=np.uint32)


def _decode_runs(runs: np.ndarray, h: int, w: int) -> np.ndarray:
    """maskApi's ``rleDecode``: alternating runs of 0 and 1, column-major (h, w)."""
    values = np.arange(len(runs)) % 2
    flat = np.repeat(values.astype(np.uint8), runs.astype(np.int64))
    out = np.zeros(h * w, np.uint8)
    out[:min(flat.size, h * w)] = flat[:h * w]
    return out.reshape((w, h)).T


def decode(rle: Union[Dict, List[Dict]]) -> np.ndarray:
    """The mask (h, w) of an RLE object, or the masks (h, w, n) of a list of them (``pycocotools.mask.decode``)."""
    if isinstance(rle, list):
        if not rle:
            return np.zeros((0, 0, 0), np.uint8)
        return np.stack([decode(r) for r in rle], axis=2)
    h, w = (int(v) for v in rle["size"])
    return _decode_runs(_runs(rle), h, w)


def _merge_runs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """maskApi's ``rleMerge`` (union) of two run-length lists over the same size."""
    cnts, ca, cb = [], int(a[0]), int(b[0])
    v = va = vb = 0
    ia = ib = 1
    cc, ct = 0, 1
    while ct > 0:
        c = min(ca, cb)
        cc += c
        ct = 0
        ca -= c
        if not ca and ia < len(a):
            ca, ia, va = int(a[ia]), ia + 1, 1 - va
        ct += ca
        cb -= c
        if not cb and ib < len(b):
            cb, ib, vb = int(b[ib]), ib + 1, 1 - vb
        ct += cb
        vp = v
        v = va or vb
        if v != vp or ct == 0:
            cnts.append(cc)
            cc = 0
    return np.asarray(cnts, np.uint32)


def merge(rles: List[Dict]) -> Dict:
    """The union of RLE objects of one size (``pycocotools.mask.merge``)."""
    if not rles:
        return {"size": [0, 0], "counts": b""}
    h, w = (int(v) for v in rles[0]["size"])
    runs = _runs(rles[0])
    for rle in rles[1:]:
        if [int(v) for v in rle["size"]] != [h, w]:
            h = w = 0
            runs = np.zeros(0, np.uint32)
            break
        runs = _merge_runs(runs, _runs(rle))
    return {"size": [h, w], "counts": rle_to_string(runs)}


def _runs_from_polygon(xy: Sequence[float], h: int, w: int) -> np.ndarray:
    """maskApi's ``rleFrPoly`` of one polygon (x0, y0, x1, y1, ...)."""
    k = len(xy) // 2
    scale = 5.0
    xy = np.asarray(xy[:2 * k], np.float64).reshape(k, 2)
    # C's (int) cast truncates towards zero
    x = np.trunc(scale * xy[:, 0] + 0.5).astype(np.int64)
    y = np.trunc(scale * xy[:, 1] + 0.5).astype(np.int64)
    x, y = np.append(x, x[:1]), np.append(y, y[:1])
    u, v = [], []
    for j in range(k):
        xs, xe, ys, ye = int(x[j]), int(x[j + 1]), int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx else 0.0
            t = np.arange(dx + 1)
            t = dx - t if flip else t
            u.append(t + xs)
            v.append(np.trunc(ys + s * t + 0.5).astype(np.int64))
        else:
            s = (xe - xs) / dy
            t = np.arange(dy + 1)
            t = dy - t if flip else t
            v.append(t + ys)
            u.append(np.trunc(xs + s * t + 0.5).astype(np.int64))
    u = np.concatenate(u) if u else np.zeros(0, np.int64)
    v = np.concatenate(v) if v else np.zeros(0, np.int64)
    # the points where the traced x changes, mapped back to pixel columns
    changed = np.flatnonzero(u[1:] != u[:-1]) + 1
    up, uq, vp, vq = u[changed], u[changed - 1], v[changed], v[changed - 1]
    xd = np.where(up < uq, up, up - 1).astype(np.float64)
    xd = (xd + 0.5) / scale - 0.5
    keep = (np.floor(xd) == xd) & (xd >= 0) & (xd <= w - 1)
    yd = np.where(vp < vq, vp, vq).astype(np.float64)
    yd = (yd + 0.5) / scale - 0.5
    yd = np.ceil(np.clip(yd, 0, h))
    xd, yd = xd[keep].astype(np.int64), yd[keep].astype(np.int64)
    # the transitions, column-major, as run lengths
    a = np.sort(np.append(xd * h + yd, h * w).astype(np.uint32))
    a = np.diff(np.concatenate(([0], a.astype(np.int64))))
    b, j = [int(a[0])], 1
    while j < len(a):
        if a[j] > 0:
            b.append(int(a[j]))
            j += 1
        else:
            j += 1
            if j < len(a):
                b[-1] += int(a[j])
                j += 1
    return np.asarray(b, np.uint32)


def _from_polygons(polygons, h, w) -> List[Dict]:
    return [{"size": [h, w], "counts": rle_to_string(_runs_from_polygon(p, h, w))} for p in polygons]


def _from_boxes(boxes, h, w) -> List[Dict]:
    """maskApi's ``rleFrBbox``: each box (x, y, width, height) as the polygon of its corners."""
    polygons = []
    for x0, y0, bw, bh in np.asarray(boxes, np.float64).reshape(-1, 4):
        x1, y1 = x0 + bw, y0 + bh
        polygons.append([x0, y0, x0, y1, x1, y1, x1, y0])
    return _from_polygons(polygons, h, w)


def _from_uncompressed(rles) -> List[Dict]:
    return [{"size": list(r["size"]), "counts": rle_to_string(np.asarray(r["counts"], np.uint32))} for r in rles]


def frPyObjects(obj, h: int, w: int):
    """RLE objects of polygons, boxes or uncompressed RLE, dispatched on the object's type as
    ``pycocotools.mask.frPyObjects`` does (a list whose first entry has 4 numbers is a list of boxes)."""
    if isinstance(obj, np.ndarray):
        return _from_boxes(obj, h, w)
    if isinstance(obj, list) and len(obj[0]) == 4:
        return _from_boxes(obj, h, w)
    if isinstance(obj, list) and len(obj[0]) > 4:
        return _from_polygons(obj, h, w)
    if isinstance(obj, list) and isinstance(obj[0], dict) and "counts" in obj[0] and "size" in obj[0]:
        return _from_uncompressed(obj)
    if isinstance(obj, list) and len(obj) == 4:
        return _from_boxes([obj], h, w)[0]
    if isinstance(obj, list) and len(obj) > 4:
        return _from_polygons([obj], h, w)[0]
    if isinstance(obj, dict) and "counts" in obj and "size" in obj:
        return _from_uncompressed([obj])[0]
    raise TypeError("input type is not supported.")


def _is_array_like(obj) -> bool:
    return hasattr(obj, "__iter__") and hasattr(obj, "__len__")


class COCO:
    """The index of a COCO annotation file (``pycocotools.coco.COCO``): images and annotations by id, the
    annotations of each image in file order."""

    def __init__(self, annotation_file: Union[str, os.PathLike, None] = None):
        self.dataset, self.anns, self.imgs = {}, {}, {}
        self.imgToAnns = defaultdict(list)
        if annotation_file is not None:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            if not isinstance(self.dataset, dict):
                raise TypeError(f"annotation file format {type(self.dataset)} not supported")
            self.createIndex()

    def createIndex(self):
        anns, imgs = {}, {}
        img_to_anns = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            img_to_anns[ann["image_id"]].append(ann)
            anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
        self.anns, self.imgToAnns, self.imgs = anns, img_to_anns, imgs

    def getAnnIds(self, imgIds=[]) -> List:
        imgIds = imgIds if _is_array_like(imgIds) else [imgIds]
        if len(imgIds) == 0:
            anns = self.dataset["annotations"]
        else:
            anns = itertools.chain.from_iterable(self.imgToAnns[i] for i in imgIds if i in self.imgToAnns)
        return [a["id"] for a in anns]

    def getImgIds(self) -> List:
        return list(self.imgs.keys())

    def _load(self, table, ids):
        if _is_array_like(ids):
            return [table[i] for i in ids]
        if isinstance(ids, int):
            return [table[ids]]
        return None

    def loadAnns(self, ids=[]) -> List[Dict]:
        return self._load(self.anns, ids)

    def loadImgs(self, ids=[]) -> List[Dict]:
        return self._load(self.imgs, ids)

    def annToRLE(self, ann: Dict) -> Dict:
        """The RLE object of an annotation: its polygons merged, its uncompressed RLE compressed, or its own."""
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            return merge(frPyObjects(segm, h, w))
        if isinstance(segm["counts"], list):
            return frPyObjects(segm, h, w)
        return segm

    def annToMask(self, ann: Dict) -> np.ndarray:
        return decode(self.annToRLE(ann))
