"""The port's geometry (``utils/geometry.py``): WKB built here by hand (both byte orders, ISO Z, EWKB), GeoJSON
Polygons and MultiPolygons with holes, ``GeoFrame``'s exact ``.cx`` window selection (a polygon whose bounding box
overlaps the window but that does not touch it is left out; a touching one is kept), ``translate``, ``scale``,
``centroid`` and ``total_bounds``; ``rasterize`` on random-float polygons with holes against a brute-force
pixel-centre even-odd test, with a transform from ``from_bounds``, and its edge rules on pixel-aligned shapes.
geopandas, rasterio and shapely are installed on neither machine."""

import json
import struct

import numpy as np
import pytest

from torch_em_tpu_torch.utils import geometry


def ring(*points):
    return np.array(points + points[:1], np.float64)


def wkb_polygon(rings, order="<", kind=3, dims=2):
    out = bytes([1 if order == "<" else 0]) + struct.pack(order + "II", kind, len(rings))
    for r in rings:
        coords = np.hstack([r, np.full((len(r), dims - 2), 9.0)]) if dims > 2 else r
        out += struct.pack(order + "I", len(r)) + coords.astype(order + "f8").tobytes()
    return out


SQUARE = ring((0, 0), (10, 0), (10, 10), (0, 10))
HOLE = ring((4, 4), (4, 6), (6, 6), (6, 4))


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("kind, dims", [(3, 2), (1003, 3), (2003, 3), (3003, 4)])
def test_wkb_polygon(order, kind, dims):
    poly = geometry.from_wkb(wkb_polygon([SQUARE, HOLE], order, kind, dims))
    assert isinstance(poly, geometry.Polygon) and len(poly.interiors) == 1
    np.testing.assert_array_equal(poly.exterior, SQUARE)
    np.testing.assert_array_equal(poly.interiors[0], HOLE)


@pytest.mark.parametrize("order", ["<", ">"])
def test_wkb_multipolygon_and_ewkb(order):
    other = ring((20, 20), (25, 20), (25, 25))
    data = bytes([1 if order == "<" else 0]) + struct.pack(order + "II", 6, 2) + \
        wkb_polygon([SQUARE], ">") + wkb_polygon([other, ], "<")
    multi = geometry.from_wkb(data)
    assert isinstance(multi, geometry.MultiPolygon) and len(multi.geoms) == 2
    np.testing.assert_array_equal(multi.geoms[1].exterior, other)
    assert multi.bounds == (0.0, 0.0, 25.0, 25.0)
    ewkb = bytes([1]) + struct.pack("<II", 0x80000000 | 0x20000000 | 3, 4326) + struct.pack("<I", 1) + \
        struct.pack("<I", len(SQUARE)) + np.hstack([SQUARE, np.ones((len(SQUARE), 1))]).astype("<f8").tobytes()
    np.testing.assert_array_equal(geometry.from_wkb(ewkb).exterior, SQUARE)
    z_multi = bytes([1]) + struct.pack("<II", 1006, 1) + wkb_polygon([SQUARE], "<", 1003, 3)
    np.testing.assert_array_equal(geometry.from_wkb(z_multi).geoms[0].exterior, SQUARE)
    with pytest.raises(ValueError, match="WKB geometry type 1"):
        geometry.from_wkb(bytes([1]) + struct.pack("<Idd", 1, 0.0, 0.0))


def test_geojson_shapes_and_read(tmp_path):
    poly = geometry.shape({"type": "Polygon", "coordinates": [SQUARE.tolist(), HOLE.tolist()]})
    assert poly == geometry.Polygon(SQUARE, [HOLE])
    multi = geometry.shape({"type": "MultiPolygon", "coordinates": [
        [np.hstack([SQUARE, np.zeros((5, 1))]).tolist()], [(SQUARE + 20).tolist()]]})
    assert isinstance(multi, geometry.MultiPolygon) and multi.geoms[0] == geometry.Polygon(SQUARE)
    with pytest.raises(ValueError, match="LineString"):
        geometry.shape({"type": "LineString", "coordinates": [[0, 0], [1, 1]]})
    features = [{"type": "Feature", "geometry": {"type": "Polygon", "coordinates": [SQUARE.tolist()]},
                 "properties": {"classification": {"name": "nuclei_tumor"}}},
                {"type": "Feature", "geometry": None, "properties": {"extra": 1}}]
    path = tmp_path / "a.geojson"
    path.write_text(json.dumps({"type": "FeatureCollection", "features": features}))
    frame = geometry.read_geojson(str(path))
    assert len(frame) == 2 and frame["classification"] == [{"name": "nuclei_tumor"}, None]
    assert frame["extra"] == [None, 1] and frame.geoms[1] is None
    np.testing.assert_array_equal(frame.total_bounds, [0, 0, 10, 10])


def test_cx_is_an_exact_intersection_with_the_closed_window():
    """geopandas' ``.cx`` is ``intersects(box)``: a triangle whose bounding box covers the window's corner but
    whose hypotenuse passes by is left out, one that touches the window at a point is kept, a window inside a
    polygon selects it, a window inside its hole does not."""
    near = geometry.Polygon(ring((0, 10), (10, 0), (10, 10)))  # x + y >= 10
    touching = geometry.Polygon(ring((4, 5.5), (8, 4), (8, 8)))
    around = geometry.Polygon(ring((-50, -50), (50, -50), (50, 50), (-50, 50)), [ring((1, 1), (1, 3), (3, 3), (3, 1))])
    frame = geometry.GeoFrame([near, touching, around], {"id": [1, 2, 3]})
    assert frame.cx[0:4, 0:4]["id"] == [3]
    assert frame.cx[0:5, 0:5]["id"] == [1, 3]  # (5, 5) lies on the hypotenuse
    assert frame.cx[0:4, 0:5.5]["id"] == [2, 3]  # (4, 5.5) is the window's corner
    assert frame.cx[1.5:2.5, 1.5:2.5]["id"] == []  # inside the hole of ``around``
    assert frame.cx[1.5:2.5, 0.5:2.5]["id"] == [3]  # crosses the hole's edge
    assert frame.cx[:, :]["id"] == [1, 2, 3] and frame.cx[4, 5.5]["id"] == [2, 3]


def clipped_area(poly, box):
    """The area of ``poly`` clipped to ``box`` (Sutherland-Hodgman against each side of the box)."""
    x0, y0, x1, y1 = box
    pts = list(map(tuple, poly[:-1]))
    for inside, cut in ((lambda p: p[0] >= x0, lambda p, q: (x0, p[1] + (x0 - p[0]) * (q[1] - p[1]) / (q[0] - p[0]))),
                        (lambda p: p[0] <= x1, lambda p, q: (x1, p[1] + (x1 - p[0]) * (q[1] - p[1]) / (q[0] - p[0]))),
                        (lambda p: p[1] >= y0, lambda p, q: (p[0] + (y0 - p[1]) * (q[0] - p[0]) / (q[1] - p[1]), y0)),
                        (lambda p: p[1] <= y1, lambda p, q: (p[0] + (y1 - p[1]) * (q[0] - p[0]) / (q[1] - p[1]), y1))):
        out = []
        for p, q in zip(pts, pts[1:] + pts[:1]):
            if inside(q):
                if not inside(p):
                    out.append(cut(p, q))
                out.append(q)
            elif inside(p):
                out.append(cut(p, q))
        pts = out
        if not pts:
            return 0.0
    x, y = np.array(pts).T
    return abs(float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))) / 2


def test_cx_against_clipping_on_random_polygons():
    """On random triangles and windows (random floats: no touching cases), the selection is the triangles whose
    clip to the window has an area."""
    rng = np.random.default_rng(0)
    triangles = [np.vstack([p, p[:1]]) for p in rng.uniform(0, 100, (300, 3, 2))]
    frame = geometry.GeoFrame([geometry.Polygon(t) for t in triangles])
    for x0, y0 in rng.uniform(0, 80, (20, 2)):
        box = (x0, y0, x0 + rng.uniform(1, 20), y0 + rng.uniform(1, 20))
        expected = [clipped_area(t, box) > 0 for t in triangles]
        assert frame.intersects_box(box).tolist() == expected
        assert len(frame.cx[box[0]:box[2], box[1]:box[3]]) == sum(expected)


def test_translate_scale_centroid():
    frame = geometry.GeoFrame([geometry.Polygon(SQUARE, [HOLE]),
                               geometry.MultiPolygon([geometry.Polygon(SQUARE), geometry.Polygon(SQUARE + 20)])])
    moved = frame.translate(xoff=-3.0, yoff=2.5)
    np.testing.assert_array_equal(moved.geoms[0].exterior, SQUARE + (-3.0, 2.5))
    np.testing.assert_array_equal(moved.geoms[0].interiors[0], HOLE + (-3.0, 2.5))
    scaled = frame.scale(xfact=0.5, yfact=0.25, origin=(0, 0))
    np.testing.assert_array_equal(scaled.geoms[1].geoms[1].exterior, (SQUARE + 20) * (0.5, 0.25))
    centred = frame.scale(xfact=2.0, yfact=2.0, origin=(5.0, 5.0))
    assert centred.geoms[0].bounds == (-5.0, -5.0, 15.0, 15.0)
    np.testing.assert_allclose(frame.centroid, [[5, 5], [15, 15]])
    l_shape = geometry.Polygon(ring((0, 0), (2, 0), (2, 1), (1, 1), (1, 2), (0, 2)))
    off_centre_hole = geometry.Polygon(SQUARE, [ring((1, 1), (1, 3), (3, 3), (3, 1))])
    np.testing.assert_allclose(geometry.GeoFrame([l_shape, off_centre_hole]).centroid,
                               [[5 / 6, 5 / 6], [(100 * 5 - 4 * 2) / 96, (100 * 5 - 4 * 2) / 96]])
    np.testing.assert_array_equal(frame.total_bounds, [0, 0, 30, 30])


def brute_force(rings, shape):
    """Pixel centres inside by the even-odd rule over all rings (edges over [lower y, upper y), a centre inside
    only right of an edge)."""
    cy, cx = np.mgrid[:shape[0], :shape[1]] + 0.5
    inside = np.zeros(shape, bool)
    for r in rings:
        for (x1, y1), (x2, y2) in zip(r[:-1], r[1:]):
            if y1 != y2:
                inside ^= (cy >= min(y1, y2)) & (cy < max(y1, y2)) & (cx > x1 + (cy - y1) * (x2 - x1) / (y2 - y1))
    return inside


def random_polygon(rng, extent):
    """A star-shaped ring with random float vertices, and sometimes a hole or a second hole, in either
    orientation."""
    c, r = rng.uniform(-5, extent + 5, 2), rng.uniform(1, extent / 2)
    n = int(rng.integers(3, 14))
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    radii = r * rng.uniform(0.4, 1, n)
    outer = np.stack([c[0] + radii * np.cos(angles), c[1] + radii * np.sin(angles)], axis=1)
    holes = []
    for k in range(int(rng.integers(0, 3))):
        ha = np.sort(rng.uniform(0, 2 * np.pi, 5))
        hc = c + (k - 0.5) * 0.25 * r * np.array([1, 0])
        holes.append(np.stack([hc[0] + 0.15 * r * np.cos(ha), hc[1] + 0.15 * r * np.sin(ha)], axis=1))
    rings = [outer[::-1] if rng.random() < 0.5 else outer] + holes
    return [np.vstack([q, q[:1]]) for q in rings]


def test_rasterize_random_polygons_against_the_brute_force():
    rng = np.random.default_rng(1)
    for _ in range(200):
        h, w = (int(v) for v in rng.integers(4, 48, 2))
        rings = random_polygon(rng, max(h, w))
        got = geometry.rasterize([(geometry.Polygon(rings[0], rings[1:]), 7)], (h, w), fill=0, dtype=np.int32)
        np.testing.assert_array_equal(got, np.where(brute_force(rings, (h, w)), 7, 0))


def test_rasterize_replaces_in_order_and_burns_multipolygon_parts_apart():
    """Later shapes replace earlier ones; the parts of a MultiPolygon burn one after the other, so two parts that
    overlap are both filled (no even-odd between parts); GeoJSON dicts are taken too."""
    a = geometry.Polygon(ring((0.2, 0.2), (6.3, 0.2), (6.3, 6.1), (0.2, 6.1)))
    b = geometry.Polygon(ring((3.4, 3.3), (9.6, 3.3), (9.6, 9.4), (3.4, 9.4)))
    got = geometry.rasterize([(a, 1), ({"type": "Polygon", "coordinates": [b.exterior.tolist()]}, 2)], (10, 10))
    expected = np.zeros((10, 10), np.uint8)
    expected[0:6, 0:6] = 1
    expected[3:9, 3:10] = 2
    np.testing.assert_array_equal(got, expected)
    both = geometry.rasterize([geometry.MultiPolygon([a, b])], (10, 10), fill=5)
    np.testing.assert_array_equal(both, np.where(expected > 0, 1, 5))


def test_rasterize_edge_rules_on_pixel_aligned_shapes():
    """GDAL's rules where centres lie on edges: a vertical edge through centres burns the centres right of it, not
    those left of it (cut at floor(x + 0.5)); a horizontal edge on a centre line burns its row when it runs from
    right to left (the lower edge of a counter-clockwise ring in these coordinates is skipped, as edges are
    counted over [lower y, upper y))."""
    square = geometry.Polygon(ring((1.5, 1.5), (4.5, 1.5), (4.5, 4.5), (1.5, 4.5)))
    got = geometry.rasterize([square], (7, 7))
    expected = np.zeros((7, 7), np.uint8)
    expected[1:4, 2:5] = 1  # rows 1-3: y = 1.5 is counted, 4.5 is not; columns 2-4: x = 1.5 is left, 4.5 right
    expected[4, 2:5] = 1  # the top edge y = 4.5 runs from x = 4.5 to 1.5, right to left: its row burns
    np.testing.assert_array_equal(got, expected)
    clockwise = geometry.Polygon(square.exterior[::-1])
    expected[4] = 0
    expected[1, 2:5] = 1  # now the edge y = 1.5 runs right to left; it was burned already by the crossing rule
    np.testing.assert_array_equal(geometry.rasterize([clockwise], (7, 7)), expected)


def test_from_bounds_and_the_inverse_transform():
    """rasterio's ``from_bounds(w, s, e, n, width, height)`` is ``translation(w, n) * scale((e - w) / width,
    (s - n) / height)``; burning through it is burning the mapped polygon with the identity."""
    transform = geometry.from_bounds(100.0, 50.0, 164.0, 82.0, 32, 16)
    assert transform == (2.0, 0.0, 100.0, 0.0, -2.0, 82.0)
    rng = np.random.default_rng(2)
    for _ in range(50):
        rings = random_polygon(rng, 32)
        world = [np.stack([100.0 + 2.0 * r[:, 0], 82.0 - 2.0 * r[:, 1]], axis=1) for r in rings]
        got = geometry.rasterize([(geometry.Polygon(world[0], world[1:]), 3)], (16, 32), transform=transform)
        np.testing.assert_array_equal(got, np.where(brute_force(rings, (16, 32)), 3, 0))
    rotated = (1.0, 0.5, 0.0, 0.25, 1.0, 0.0)
    inv = geometry._inverse(rotated)
    x, y = 3.0 * 1.0 + 2.0 * 0.5, 3.0 * 0.25 + 2.0 * 1.0  # pixel (3, 2)
    np.testing.assert_allclose([inv[0] + inv[1] * x + inv[2] * y, inv[3] + inv[4] * x + inv[5] * y], [3, 2])
    with pytest.raises(ValueError, match="cannot be inverted"):
        geometry._inverse((1.0, 1.0, 0.0, 1.0, 1.0, 0.0))
