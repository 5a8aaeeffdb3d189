"""Polygons from GeoJSON and WKB, a small table of them, and burning them into a raster, in numpy, with no
geopandas, rasterio or shapely.

- ``shape(geojson)`` and ``from_wkb(data)`` give a ``Polygon`` (an exterior ring and its holes) or a
  ``MultiPolygon``: GeoJSON Polygon and MultiPolygon, WKB Polygon (3) and MultiPolygon (6) in either
  byte order, with their ISO Z, M and ZM variants (1003, 2003, 3003, ...) and EWKB's flags; only x and
  y are kept.
- ``GeoFrame`` holds geometries and columns and offers what the readers call on a GeoDataFrame:
  ``total_bounds``; ``cx[x0:x1, y0:y1]``, which keeps the rows whose geometry intersects the closed
  window box exactly (geopandas' ``.cx`` is ``intersects(box(...))``, not a bounding-box overlap);
  ``translate``; ``scale`` about an origin; and the area-weighted ``centroid`` (GEOS' triangle fan).
  ``read_geojson`` reads a FeatureCollection into one, its properties as columns.
- ``rasterize(shapes, out_shape, transform, fill, dtype)`` follows ``rasterio.features.rasterize`` at its
  defaults (``all_touched=False``, ``merge_alg`` REPLACE in iteration order), that is GDAL's scanline
  fill (``llrasterize.cpp``): on each row the edges that cross the pixel centres' line y + 0.5, each
  counted over [lower y, upper y), cut it at x, rounded as floor(x + 0.5); the sorted cuts pair up and
  the pixels from one cut to the next but one are burned. A pixel is burned where its centre lies inside by
  the even-odd rule over all rings of a polygon; a centre exactly on a left edge is outside, on a right
  edge inside, and a horizontal edge on the centre line that runs from right to left is burned too. The
  parts of a MultiPolygon burn one after the other. ``from_bounds`` is rasterio's
  ``translation(w, n) * scale((e - w) / width, (s - n) / height)``; world coordinates go to pixels through
  GDAL's inverse geotransform.
"""

import json
import struct
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["Polygon", "MultiPolygon", "GeoFrame", "shape", "from_wkb", "read_geojson", "rasterize", "from_bounds",
           "IDENTITY"]

# affine transforms as rasterio's Affine holds them: x = a * col + b * row + c, y = d * col + e * row + f
IDENTITY = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


class Polygon:
    """An exterior ring and its holes, each an (n, 2) float64 array of (x, y)."""

    def __init__(self, exterior, holes=()):
        self.rings = [np.asarray(exterior, np.float64).reshape(-1, 2)] + \
            [np.asarray(h, np.float64).reshape(-1, 2) for h in holes]

    @property
    def exterior(self) -> np.ndarray:
        return self.rings[0]

    @property
    def interiors(self) -> List[np.ndarray]:
        return self.rings[1:]

    @property
    def parts(self) -> List["Polygon"]:
        return [self]

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        ring = self.rings[0]
        if not len(ring):
            return (np.nan,) * 4
        return tuple(float(v) for v in (*ring.min(axis=0), *ring.max(axis=0)))

    def _map(self, fn) -> "Polygon":
        return Polygon(fn(self.rings[0]), [fn(h) for h in self.rings[1:]])

    def __eq__(self, other):
        return isinstance(other, Polygon) and len(other.rings) == len(self.rings) and \
            all(np.array_equal(a, b) for a, b in zip(self.rings, other.rings))

    def __repr__(self):
        return f"Polygon({len(self.rings[0])} vertices, {len(self.rings) - 1} holes)"


class MultiPolygon:
    """Polygons, burned and tested one by one."""

    def __init__(self, polygons: Sequence[Polygon]):
        self.geoms = list(polygons)

    @property
    def parts(self) -> List[Polygon]:
        return self.geoms

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        boxes = np.array([p.bounds for p in self.geoms]).reshape(-1, 4)
        if not len(boxes):
            return (np.nan,) * 4
        return (float(boxes[:, 0].min()), float(boxes[:, 1].min()), float(boxes[:, 2].max()),
                float(boxes[:, 3].max()))

    def _map(self, fn) -> "MultiPolygon":
        return MultiPolygon([p._map(fn) for p in self.geoms])

    def __eq__(self, other):
        return isinstance(other, MultiPolygon) and len(other.geoms) == len(self.geoms) and \
            all(a == b for a, b in zip(self.geoms, other.geoms))

    def __repr__(self):
        return f"MultiPolygon({len(self.geoms)} polygons)"


Geometry = Union[Polygon, MultiPolygon]


def shape(geojson: Dict) -> Geometry:
    """A GeoJSON Polygon or MultiPolygon geometry."""
    kind, coords = geojson["type"], geojson["coordinates"]

    def polygon(rings):
        rings = [np.asarray(r, np.float64).reshape(len(r), -1)[:, :2] for r in rings]
        return Polygon(rings[0], rings[1:]) if rings else Polygon(np.zeros((0, 2)))

    if kind == "Polygon":
        return polygon(coords)
    if kind == "MultiPolygon":
        return MultiPolygon([polygon(p) for p in coords])
    raise ValueError(f"geometry type {kind!r} is not supported (Polygon and MultiPolygon are)")


def _wkb(buf, pos) -> Tuple[Geometry, int]:
    order = "<" if buf[pos] == 1 else ">"
    kind = struct.unpack_from(order + "I", buf, pos + 1)[0]
    pos += 5
    dims = 2
    if kind & 0x20000000:  # EWKB: an SRID follows
        pos += 4
    dims += bool(kind & 0x80000000) + bool(kind & 0x40000000)
    kind &= 0x0FFFFFFF
    iso, base = divmod(kind, 1000)
    dims += {0: 0, 1: 1, 2: 1, 3: 2}.get(iso, 0)
    if base == 3:
        n_rings = struct.unpack_from(order + "I", buf, pos)[0]
        pos += 4
        rings = []
        for _ in range(n_rings):
            n = struct.unpack_from(order + "I", buf, pos)[0]
            pos += 4
            rings.append(np.frombuffer(buf, order + "f8", n * dims, pos).reshape(n, dims)[:, :2].astype(np.float64))
            pos += 8 * n * dims
        return (Polygon(rings[0], rings[1:]) if rings else Polygon(np.zeros((0, 2)))), pos
    if base == 6:
        n = struct.unpack_from(order + "I", buf, pos)[0]
        pos += 4
        polygons = []
        for _ in range(n):
            poly, pos = _wkb(buf, pos)
            polygons.append(poly)
        return MultiPolygon(polygons), pos
    raise ValueError(f"WKB geometry type {kind} is not supported (Polygon 3 and MultiPolygon 6 are, with their "
                     "Z, M and ZM variants)")


def from_wkb(data: bytes) -> Geometry:
    """A WKB (or EWKB) Polygon or MultiPolygon."""
    return _wkb(bytes(data), 0)[0]


def _signed_area2(ring: np.ndarray) -> float:
    x, y = ring[:, 0], ring[:, 1]
    return float(np.sum(x[:-1] * y[1:] - x[1:] * y[:-1]))


def _centroid(geom: Geometry) -> Tuple[float, float]:
    """GEOS' area centroid: triangles fanned from the first point of each polygon's shell, shells counted with
    the sign that makes their area positive, holes with the other, summed in order."""
    terms, base = [], None
    for poly in geom.parts:
        if not len(poly.exterior):
            continue
        if base is None:  # GEOS keeps the first shell's first point as the base of every triangle
            base = poly.exterior[0]
        for k, ring in enumerate(poly.rings):
            ccw = _signed_area2(ring) > 0
            sign = 1.0 if (not ccw if k == 0 else ccw) else -1.0
            p1, p2 = ring[:-1], ring[1:]
            area2 = (p1[:, 0] - base[0]) * (p2[:, 1] - base[1]) - (p2[:, 0] - base[0]) * (p1[:, 1] - base[1])
            terms.append(np.stack([sign * area2 * (base[0] + p1[:, 0] + p2[:, 0]),
                                   sign * area2 * (base[1] + p1[:, 1] + p2[:, 1]), sign * area2], axis=1))
    if not terms:
        return np.nan, np.nan
    # in order, one term after the other, as GEOS adds them
    cx, cy, area = np.cumsum(np.concatenate(terms), axis=0)[-1]
    if area == 0:
        points = np.concatenate([r for p in geom.parts for r in p.rings])
        return float(points[:, 0].mean()), float(points[:, 1].mean())
    return cx / 3 / area, cy / 3 / area


def _segments_meet_box(p, q, box) -> np.ndarray:
    """Whether each segment p[i]-q[i] meets the closed box (x0, y0, x1, y1), by separating axes: the box's two
    axes and the segment's normal."""
    x0, y0, x1, y1 = box
    overlap = (np.minimum(p[:, 0], q[:, 0]) <= x1) & (np.maximum(p[:, 0], q[:, 0]) >= x0) & \
        (np.minimum(p[:, 1], q[:, 1]) <= y1) & (np.maximum(p[:, 1], q[:, 1]) >= y0)
    d = q - p
    sides = np.stack([d[:, 0] * (cy - p[:, 1]) - d[:, 1] * (cx - p[:, 0])
                      for cx, cy in ((x0, y0), (x1, y0), (x1, y1), (x0, y1))], axis=1)
    return overlap & ~((sides > 0).all(axis=1) | (sides < 0).all(axis=1))


def _inside(rings: Sequence[np.ndarray], x: float, y: float) -> bool:
    """Even-odd point in polygon over all rings."""
    crossings = 0
    for ring in rings:
        p, q = ring, np.roll(ring, -1, axis=0)
        straddle = (p[:, 1] > y) != (q[:, 1] > y)
        xs = p[straddle, 0] + (y - p[straddle, 1]) * (q[straddle, 0] - p[straddle, 0]) / \
            (q[straddle, 1] - p[straddle, 1])
        crossings += int(np.count_nonzero(x < xs))
    return crossings % 2 == 1


def _intersects_box(geom: Geometry, box) -> bool:
    """shapely's ``geom.intersects(box(*box))``: boundaries that meet or touch, or the box inside the polygon."""
    for poly in geom.parts:
        rings = [r for r in poly.rings if len(r)]
        if not rings:
            continue
        edges = [(r, np.roll(r, -1, axis=0)) for r in rings]
        if any(_segments_meet_box(p, q, box).any() for p, q in edges):
            return True
        if _inside(rings, box[0], box[1]):  # no boundary meets the box: it lies wholly inside or outside
            return True
    return False


class _CoordinateIndexer:
    def __init__(self, frame: "GeoFrame"):
        self.frame = frame

    def __getitem__(self, key) -> "GeoFrame":
        xs, ys = key
        xs = xs if isinstance(xs, slice) else slice(xs, xs)
        ys = ys if isinstance(ys, slice) else slice(ys, ys)
        xmin, ymin, xmax, ymax = self.frame.total_bounds
        box = (xs.start if xs.start is not None else xmin, ys.start if ys.start is not None else ymin,
               xs.stop if xs.stop is not None else xmax, ys.stop if ys.stop is not None else ymax)
        return self.frame[self.frame.intersects_box(box)]


class GeoFrame:
    """Geometries (``Polygon``, ``MultiPolygon`` or None) and columns of one value a geometry."""

    def __init__(self, geometries: Iterable[Optional[Geometry]], columns: Optional[Dict[str, Sequence]] = None):
        self.geoms = list(geometries)
        self.columns = {k: list(v) for k, v in (columns or {}).items()}
        for name, values in self.columns.items():
            if len(values) != len(self.geoms):
                raise ValueError(f"column {name!r} has {len(values)} values for {len(self.geoms)} geometries")
        self._bounds = None

    def __len__(self) -> int:
        return len(self.geoms)

    def __iter__(self):
        return iter(self.geoms)

    @property
    def geometry(self) -> "GeoFrame":
        return self

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.columns[key]
        index = np.flatnonzero(key) if np.asarray(key).dtype == bool else np.asarray(key, dtype=np.int64)
        return GeoFrame([self.geoms[i] for i in index], {k: [v[i] for i in index] for k, v in self.columns.items()})

    def __setitem__(self, name: str, values):
        values = list(values)
        if len(values) != len(self.geoms):
            raise ValueError(f"{len(values)} values for {len(self.geoms)} geometries")
        self.columns[name] = values

    @property
    def bounds(self) -> np.ndarray:
        """(n, 4) of (minx, miny, maxx, maxy), NaN for a missing geometry."""
        if self._bounds is None:
            self._bounds = np.array([g.bounds if g is not None else (np.nan,) * 4 for g in self.geoms],
                                    np.float64).reshape(-1, 4)
        return self._bounds

    @property
    def total_bounds(self) -> np.ndarray:
        b = self.bounds
        if not len(b) or np.isnan(b).all():
            return np.full(4, np.nan)
        return np.array([np.nanmin(b[:, 0]), np.nanmin(b[:, 1]), np.nanmax(b[:, 2]), np.nanmax(b[:, 3])])

    def intersects_box(self, box) -> np.ndarray:
        """Whether each geometry intersects the closed box (x0, y0, x1, y1): a bounding-box test, then the exact
        test for the geometries whose bounding box is not inside the box."""
        x0, y0, x1, y1 = box
        b = self.bounds
        with np.errstate(invalid="ignore"):
            near = (b[:, 0] <= x1) & (b[:, 2] >= x0) & (b[:, 1] <= y1) & (b[:, 3] >= y0)
            inside = (b[:, 0] >= x0) & (b[:, 2] <= x1) & (b[:, 1] >= y0) & (b[:, 3] <= y1)
        hit = near & inside
        for i in np.flatnonzero(near & ~inside):
            hit[i] = _intersects_box(self.geoms[i], box)
        return hit

    @property
    def cx(self) -> _CoordinateIndexer:
        return _CoordinateIndexer(self)

    def _map(self, fn) -> "GeoFrame":
        return GeoFrame([g._map(fn) if g is not None else None for g in self.geoms], self.columns)

    def translate(self, xoff: float = 0.0, yoff: float = 0.0) -> "GeoFrame":
        """Every geometry moved by (xoff, yoff), as ``shapely.affinity.translate`` computes it."""
        offset = np.array([xoff, yoff], np.float64)
        return self._map(lambda r: r + offset)

    def scale(self, xfact: float, yfact: float, origin: Tuple[float, float]) -> "GeoFrame":
        """Every geometry scaled by (xfact, yfact) about the point ``origin``, as ``shapely.affinity.scale``
        computes it."""
        x0, y0 = origin
        factor, offset = np.array([xfact, yfact], np.float64), np.array([x0 - x0 * xfact, y0 - y0 * yfact])
        return self._map(lambda r: r * factor + offset)

    @property
    def centroid(self) -> np.ndarray:
        """(n, 2) of each geometry's area-weighted centroid (x, y)."""
        return np.array([_centroid(g) if g is not None else (np.nan, np.nan) for g in self.geoms],
                        np.float64).reshape(-1, 2)


def read_geojson(path) -> GeoFrame:
    """A GeoJSON FeatureCollection as a ``GeoFrame``: one row a feature, its geometry and its properties as
    columns (a missing property None), in file order."""
    with open(path) as f:
        features = json.load(f)["features"]
    names = list(dict.fromkeys(k for feat in features for k in (feat.get("properties") or {})))
    geoms = [shape(feat["geometry"]) if feat.get("geometry") else None for feat in features]
    columns = {name: [(feat.get("properties") or {}).get(name) for feat in features] for name in names}
    return GeoFrame(geoms, columns)


def from_bounds(west: float, south: float, east: float, north: float, width: int, height: int) -> Tuple[float, ...]:
    """rasterio's ``transform.from_bounds``: the affine of a raster of ``width`` x ``height`` over the bounds."""
    return ((east - west) / width, 0.0, west, 0.0, (south - north) / height, north)


def _inverse(transform) -> Tuple[float, ...]:
    """GDAL's ``GDALInvGeoTransform`` of an affine (a, b, c, d, e, f), as (c', a', b', f', d', e') in GDAL's
    order: pixel x = c' + a' * x + b' * y, pixel y = f' + d' * x + e' * y."""
    a, b, c, d, e, f = (float(v) for v in transform[:6])
    gt = (c, a, b, f, d, e)
    if gt[2] == 0.0 and gt[4] == 0.0 and gt[1] != 0.0 and gt[5] != 0.0:
        return (-gt[0] / gt[1], 1.0 / gt[1], 0.0, -gt[3] / gt[5], 0.0, 1.0 / gt[5])
    det = gt[1] * gt[5] - gt[2] * gt[4]
    magnitude = max(abs(gt[1]), abs(gt[2]), abs(gt[4]), abs(gt[5]))
    if abs(det) <= 1e-10 * magnitude * magnitude:
        raise ValueError(f"the transform {transform} cannot be inverted")
    inv = 1.0 / det
    return ((gt[2] * gt[3] - gt[0] * gt[5]) * inv, gt[5] * inv, -gt[2] * inv,
            (-gt[1] * gt[3] + gt[0] * gt[4]) * inv, -gt[4] * inv, gt[1] * inv)


# rows x edges of one block of the scanline fill
BURN_BLOCK = 1 << 20


def _burn_polygon(out: np.ndarray, rings: List[np.ndarray], value) -> None:
    """GDAL's ``GDALdllImageFilledPolygon`` of one polygon's rings (pixel coordinates) into ``out``."""
    height = out.shape[0]
    rings = [r for r in rings if len(r)]
    if not rings:
        return
    # the edges (p[i - 1], p[i]) of each ring, the first from its last point
    p = np.concatenate([np.roll(r, 1, axis=0) for r in rings])
    q = np.concatenate(rings)
    lo, hi = max(int(q[:, 1].min()), 0), min(int(q[:, 1].max()), height - 1)  # C's truncating casts
    step = max(1, BURN_BLOCK // len(q))
    for first in range(lo, hi + 1, step):
        _burn_rows(out, p, q, first, min(first + step, hi + 1), value)


def _burn_rows(out, p, q, lo, stop, value):
    """The scanline fill of rows ``lo`` to ``stop`` - 1 for the edges p[i] -> q[i]."""
    width = out.shape[1]
    hi = stop - 1
    dy = (np.arange(lo, stop, dtype=np.float64) + 0.5)[:, None]
    y1, y2, x1, x2 = p[:, 1][None], q[:, 1][None], p[:, 0][None], q[:, 0][None]
    # each edge from its lower end to its upper end
    up = y1 < y2
    ly, uy = np.where(up, y1, y2), np.where(up, y2, y1)
    lx, ux = np.where(up, x1, x2), np.where(up, x2, x1)
    with np.errstate(divide="ignore", invalid="ignore"):
        cut = (dy - ly) * (ux - lx) / (uy - ly) + lx
        crosses = (ly != uy) & (dy >= ly) & (dy < uy)
        cuts = np.where(crosses, np.floor(cut + 0.5), np.inf)
    cuts.sort(axis=1)
    n_cuts = crosses.sum(axis=1)
    spans = []  # (row, first pixel, pixel after the last)
    pairs = cuts[:, :cuts.shape[1] - cuts.shape[1] % 2].reshape(len(cuts), -1, 2)
    valid = np.arange(pairs.shape[1])[None] < (n_cuts // 2)[:, None]
    rows, k = np.nonzero(valid & (pairs[..., 0] <= width - 1) & (pairs[..., 1] > 0))
    spans.append((rows, pairs[rows, k, 0], pairs[rows, k, 1]))
    # a horizontal edge on the centre line, running from right to left, is burned on its row
    flat = (y1 == y2) & (y1 == dy) & (x1 > x2)
    rows, e = np.nonzero(flat)
    if len(rows):
        start, stop = np.floor(x2[0, e] + 0.5), np.floor(x1[0, e] + 0.5)
        keep = (start <= width - 1) & (stop > 0)
        spans.append((rows[keep], start[keep], stop[keep]))
    rows = np.concatenate([s[0] for s in spans])
    if not len(rows):
        return
    start = np.clip(np.concatenate([s[1] for s in spans]), 0, width).astype(np.int64)
    stop = np.clip(np.concatenate([s[2] for s in spans]), 0, width).astype(np.int64)
    c0, c1 = int(start.min()), int(stop.max())
    if c1 <= c0:
        return
    marks = np.zeros((hi - lo + 1, c1 - c0 + 1), np.int32)
    np.add.at(marks, (rows, start - c0), 1)
    np.add.at(marks, (rows, stop - c0), -1)
    burn = np.cumsum(marks, axis=1)[:, :-1] > 0
    window = out[lo:hi + 1, c0:c1]
    window[burn] = value


def rasterize(shapes: Iterable, out_shape: Tuple[int, int], transform=IDENTITY, fill=0,
              dtype=np.uint8) -> np.ndarray:
    """Burn ``shapes``, (geometry, value) pairs or geometries (value 1), into a raster of ``out_shape`` filled
    with ``fill``, as ``rasterio.features.rasterize`` does at its defaults. A geometry is a ``Polygon``, a
    ``MultiPolygon`` or a GeoJSON dict; ``transform`` maps pixel (col, row) to the geometries' coordinates."""
    out = np.full(tuple(out_shape), fill, dtype=dtype)
    t0, t1, t2, t3, t4, t5 = _inverse(transform)
    for item in shapes:
        geom, value = item if isinstance(item, tuple) else (item, 1)
        if geom is None:
            continue
        if isinstance(geom, dict):
            geom = shape(geom)
        for poly in geom.parts:
            rings = []
            for ring in poly.rings:
                x, y = ring[:, 0], ring[:, 1]
                rings.append(np.stack([t0 + t1 * x + t2 * y, t3 + t4 * x + t5 * y], axis=1))
            _burn_polygon(out, rings, value)
    return out
