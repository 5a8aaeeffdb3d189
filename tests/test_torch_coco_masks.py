"""The port's COCO masks (``utils/coco.py``, pycocotools' ``maskApi`` in numpy) on cases worked out here from
maskApi's rules: compressed counts strings decoded by hand, column-major decoding, the union of two RLEs, polygons
against a line-by-line transcription of ``rleFrPoly`` and ``rleFrBbox`` written in this file (C's truncating casts
and all), ``frPyObjects``' dispatch, and ``COCO.annToMask`` on polygons, uncompressed and compressed RLE. Round
trips go through an encoder written in this file. pycocotools is installed on neither machine."""

import json
import math

import numpy as np
import pytest

from torch_em_tpu_torch.utils import coco


def counts_string(runs):
    """maskApi's ``rleToString``, written out here: each run from the fourth on less the one two before, 5 bits
    a character from 48, 0x20 for more to come, the sign in 0x10 of the last."""
    out = ""
    for i, run in enumerate(runs):
        x = run - runs[i - 2] if i > 2 else run
        while True:
            c, x = x & 0x1F, x >> 5
            more = x != -1 if c & 0x10 else x != 0
            out += chr((c | 0x20 if more else c) + 48)
            if not more:
                break
    return out


def runs_of(mask):
    flat = mask.ravel(order="F").astype(np.int8)
    runs = [int(r) for r in np.diff(np.concatenate(([0], np.flatnonzero(np.diff(flat)) + 1, [flat.size])))]
    return [0] + runs if flat[0] else runs


@pytest.mark.parametrize("text, runs", [
    ("81420O:", [8, 1, 4, 3, 4, 2, 14]),  # worked out by hand: 8, 1, 4, then 2 + 1, 0 + 4, -1 + 3, 10 + 4
    ("T3", [100]),  # 100 = 3 << 5 | 4: '4' + 0x20 -> 'T', then '3'
    ("0", [0]),
    ("5d0", [5, 20]),  # 'd' = 48 + 0x20 + 20: 20, more to come; '0' adds 0 << 5 and ends it, with no sign
])
def test_counts_strings_decode_by_hand(text, runs):
    assert coco.rle_from_string(text).tolist() == runs
    assert coco.rle_from_string(text.encode()).tolist() == runs
    assert coco.rle_to_string(runs).decode() == counts_string(runs)


def test_negative_differences_carry_the_sign_bit():
    """From the fourth run on a run is stored less the one two before, so a shorter run is a negative number:
    -1 is 0x1F with no continuation, -40 two characters ending in 0x10's sign."""
    runs = [50, 3, 10, 2, 49, 9, 9]
    text = counts_string(runs)
    assert coco.rle_to_string(runs).decode() == text
    assert coco.rle_from_string(text).tolist() == runs
    assert counts_string([1, 1, 1, 0]) == "111O"  # the fourth run, 0, is stored as 0 - 1 = -1: 'O' = 48 + 31
    assert coco.rle_from_string("003O").tolist() == [0, 0, 3, 0xFFFFFFFF]  # 'O' = 31: -1 + 0, stored as uint


def test_decode_is_column_major():
    """size [3, 2], runs 1, 2, 3: the flat column-major vector 0 1 1 0 0 0."""
    rle = {"size": [3, 2], "counts": counts_string([1, 2, 3])}
    np.testing.assert_array_equal(coco.decode(rle), [[0, 0], [1, 0], [1, 0]])
    assert coco.decode(rle).dtype == np.uint8
    stacked = coco.decode([rle, {"size": [3, 2], "counts": counts_string([0, 6])}])
    assert stacked.shape == (3, 2, 2) and stacked[..., 1].all()


def test_merge_is_the_union():
    """0 1 1 0 0 0 (runs 1 2 3) or 0 0 0 0 1 0 (runs 4 1 1) is 0 1 1 0 1 0: runs 1 2 1 1 1; or'd with
    1 0 0 0 0 1 (runs 0 1 4 1) too, 1 1 1 0 1 1: runs 0 3 1 2."""
    a, b = {"size": [3, 2], "counts": counts_string([1, 2, 3])}, {"size": [3, 2], "counts": counts_string([4, 1, 1])}
    assert coco.rle_from_string(coco.merge([a, b])["counts"]).tolist() == [1, 2, 1, 1, 1]
    c = {"size": [3, 2], "counts": counts_string([0, 1, 4, 1])}
    assert coco.rle_from_string(coco.merge([a, b, c])["counts"]).tolist() == [0, 3, 1, 2]
    assert coco.merge([a])["counts"] == coco.rle_to_string([1, 2, 3])
    assert coco.merge([a, {"size": [2, 3], "counts": "0"}])["size"] == [0, 0]


def fr_poly_c(xy, h, w):
    """maskApi.c's ``rleFrPoly``, line by line, in scalar Python: the runs of one polygon."""
    k = len(xy) // 2
    scale = 5.0
    x = [int(scale * xy[2 * j] + .5) for j in range(k)] + [0]  # int() truncates towards zero, as C's cast
    y = [int(scale * xy[2 * j + 1] + .5) for j in range(k)] + [0]
    x[k], y[k] = x[0], y[0]
    u, v = [], []
    for j in range(k):
        xs, xe, ys, ye = x[j], x[j + 1], y[j], y[j + 1]
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx else 0.0  # 0/0 is NaN in C; such a point is never used (u does not change)
            for d in range(dx + 1):
                t = dx - d if flip else d
                u.append(t + xs)
                v.append(int(ys + s * t + .5))
        else:
            s = (xe - xs) / dy
            for d in range(dy + 1):
                t = dy - d if flip else d
                v.append(t + ys)
                u.append(int(xs + s * t + .5))
    px, py = [], []
    for j in range(1, len(u)):
        if u[j] != u[j - 1]:
            xd = float(u[j] if u[j] < u[j - 1] else u[j] - 1)
            xd = (xd + .5) / scale - .5
            if math.floor(xd) != xd or xd < 0 or xd > w - 1:
                continue
            yd = float(v[j] if v[j] < v[j - 1] else v[j - 1])
            yd = (yd + .5) / scale - .5
            yd = 0 if yd < 0 else (h if yd > h else yd)
            yd = math.ceil(yd)
            px.append(int(xd))
            py.append(int(yd))
    a = sorted([px[j] * h + py[j] for j in range(len(px))] + [h * w])
    p = 0
    for j in range(len(a)):
        t = a[j]
        a[j] -= p
        p = t
    b, j = [a[0]], 1
    while j < len(a):
        if a[j] > 0:
            b.append(a[j])
            j += 1
        else:
            j += 1
            if j < len(a):
                b[-1] += a[j]
                j += 1
    return b


def test_polygon_square_and_box_by_hand():
    """The square (1, 1)-(3, 3) in a 5x5 image fills rows and columns 1 and 2; a box [x, y, w, h] with integer
    corners fills w x h pixels from (y, x), as pycocotools' areas of integer boxes are w * h."""
    square = coco.decode(coco.frPyObjects([[1, 1, 3, 1, 3, 3, 1, 3]], 5, 5)[0])
    expected = np.zeros((5, 5), np.uint8)
    expected[1:3, 1:3] = 1
    np.testing.assert_array_equal(square, expected)
    box = coco.decode(coco.frPyObjects([[2, 3, 7, 4]], 12, 10)[0])
    expected = np.zeros((12, 10), np.uint8)
    expected[3:7, 2:9] = 1
    np.testing.assert_array_equal(box, expected)
    assert coco.decode(coco.frPyObjects([[0, 0, 10, 0, 10, 10, 0, 10]], 20, 20)[0]).sum() == 100


def test_polygons_match_the_transcription():
    """Random polygons, some reaching past the image and some with repeated vertices, against ``fr_poly_c``."""
    rng = np.random.default_rng(0)
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        n = int(rng.integers(3, 12))
        xy = rng.uniform(-5, max(h, w) + 5, 2 * n).round(int(rng.integers(0, 3)))
        if rng.random() < 0.2:
            xy[2:4] = xy[0:2]
        poly = xy.tolist()
        got = coco.rle_from_string(coco.frPyObjects([poly], h, w)[0]["counts"]).tolist()
        assert got == fr_poly_c(poly, h, w), (poly, h, w)


def test_fr_py_objects_dispatch():
    """A list whose first entry has 4 numbers is boxes (so a 2-point polygon is read as a box, as pycocotools
    reads it); longer entries are polygons; dicts with a list of counts are uncompressed RLE, kept at their own
    size; an ndarray is boxes."""
    as_box = coco.frPyObjects([[1, 1, 2, 2]], 6, 6)[0]
    from_array = coco.frPyObjects(np.array([[1., 1, 2, 2]]), 6, 6)[0]
    np.testing.assert_array_equal(coco.decode(as_box), coco.decode(from_array))
    assert coco.decode(as_box).sum() == 4
    with pytest.raises(TypeError):  # a flat list of numbers: len() of its first number, as in pycocotools
        coco.frPyObjects([1, 1, 4, 1, 4, 4], 6, 6)
    uncompressed = coco.frPyObjects({"size": [3, 2], "counts": [1, 2, 3]}, 99, 99)
    assert uncompressed["size"] == [3, 2] and coco.rle_from_string(uncompressed["counts"]).tolist() == [1, 2, 3]
    with pytest.raises(TypeError):
        coco.frPyObjects("polygon", 3, 3)


def test_encode_decode_round_trip():
    """Random masks encoded here decode back; their compressed strings are the port's of the same runs."""
    rng = np.random.default_rng(1)
    for _ in range(100):
        h, w = (int(v) for v in rng.integers(1, 30, 2))
        mask = (rng.random((h, w)) < rng.random()).astype(np.uint8)
        runs = runs_of(mask)
        assert coco.rle_to_string(runs).decode() == counts_string(runs)
        assert coco.rle_from_string(counts_string(runs)).tolist() == runs
        np.testing.assert_array_equal(coco.decode({"size": [h, w], "counts": counts_string(runs)}), mask)


def test_coco_index_and_ann_to_mask(tmp_path):
    """``COCO`` over a file: the image ids, an image's annotations in file order, and ``annToMask`` of two polygons
    merged, of an uncompressed and of a compressed RLE (the ellipse written with this file's encoder)."""
    h, w = 20, 24
    yy, xx = np.mgrid[:h, :w]
    ellipse = (((yy - 10) / 6.5) ** 2 + ((xx - 15) / 4.2) ** 2 <= 1).astype(np.uint8)
    box = np.zeros((h, w), np.uint8)
    box[2:5, 3:9] = 1
    data = {"images": [{"id": 7, "height": h, "width": w, "file_name": "a.png"},
                       {"id": 3, "height": h, "width": w, "file_name": "b.png"}],
            "categories": [{"id": 1, "name": "organoid"}],
            "annotations": [
                {"id": 10, "image_id": 7, "category_id": 1, "iscrowd": 0, "area": 36,
                 "segmentation": [[3, 2, 9, 2, 9, 5, 3, 5], [12, 14, 16, 14, 16, 18, 12, 18]]},
                {"id": 11, "image_id": 3, "category_id": 1, "iscrowd": 0, "area": 18,
                 "segmentation": {"size": [h, w], "counts": runs_of(box)}},
                {"id": 12, "image_id": 7, "category_id": 1, "iscrowd": 1, "area": int(ellipse.sum()),
                 "segmentation": {"size": [h, w], "counts": counts_string(runs_of(ellipse))}}]}
    path = tmp_path / "coco.json"
    path.write_text(json.dumps(data))
    index = coco.COCO(str(path))
    assert index.getImgIds() == [7, 3] and index.getAnnIds(imgIds=7) == [10, 12]
    assert index.getAnnIds(imgIds=[3, 7]) == [11, 10, 12] and index.getAnnIds() == [10, 11, 12]
    assert index.getAnnIds(imgIds=[5]) == []
    assert [img["file_name"] for img in index.loadImgs(index.getImgIds())] == ["a.png", "b.png"]
    two_boxes = index.annToMask(index.loadAnns(10)[0])
    expected = np.zeros((h, w), np.uint8)
    expected[2:5, 3:9] = 1
    expected[14:18, 12:16] = 1
    np.testing.assert_array_equal(two_boxes, expected)
    np.testing.assert_array_equal(index.annToMask(index.loadAnns([11])[0]), box)
    np.testing.assert_array_equal(index.annToMask(index.loadAnns(12)[0]), ellipse)
    assert index.loadImgs(np.int64(7)) is None  # pycocotools loads by int or by a list only
