"""Wavefront .obj parser tests (reference semantics: Geometry.hs:207-285)."""
import numpy as np
import pytest

from raytrace_tpu.scene.obj import ObjParseError, parse_obj, read_obj


def test_basic():
    m = parse_obj("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    assert m.vertices.shape == (3, 3)
    assert m.faces.tolist() == [[0, 1, 2]]
    assert m.uv_faces.tolist() == [[-1, -1, -1]]


def test_comments_and_ignored_lines():
    m = parse_obj(
        "# header\nv 0 0 0 # inline\nv 1 0 0\nv 0 1 0\n"
        "vn 0 0 1\ng name\ns off\nf 1 2 3\n"
    )
    assert m.faces.tolist() == [[0, 1, 2]]


def test_fan_triangulation():
    m = parse_obj("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 2 0\nf 1 2 3 4 5\n")
    # pairs: (1,2,3) (1,3,4) (1,4,5) zero-based
    assert m.faces.tolist() == [[0, 1, 2], [0, 2, 3], [0, 3, 4]]


def test_negative_indices():
    m = parse_obj("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    assert m.faces.tolist() == [[0, 1, 2]]


def test_uv_indices_and_double_slash():
    m = parse_obj(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\n"
        "f 1/1 2/2 3/3\nf 1//1 2//2 3//3\n"
    )
    assert m.uv_faces.tolist() == [[0, 1, 2], [-1, -1, -1]]
    assert m.uv.shape == (3, 2)


def test_vt_single_number_defaults_v0():
    m = parse_obj("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0.5\nf 1/1 2/1 3/1\n")
    assert m.uv.tolist() == [[0.5, 0.0]]


def test_extra_fields_ignored():
    m = parse_obj("v 1 2 3 1.0\nv 4 5 6\nv 7 8 9\nvt 0.1 0.2 0.3\nf 1 2 3\n")
    assert m.vertices[0].tolist() == [1.0, 2.0, 3.0]
    assert m.uv[0].tolist() == [0.1, 0.2]


@pytest.mark.parametrize("text,msg", [
    ("v 1 2\nf 1 1 1\n", "invalid 'v'"),
    ("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt x\nf 1 2 3\n", "invalid 'vt'"),
    ("v 0 0 0\nf 1 2 3\n", "out of bounds"),
    ("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2\n", "fewer than 3"),
    ("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 x\n", "expected number"),
])
def test_errors_with_line_numbers(text, msg):
    with pytest.raises(ObjParseError) as e:
        parse_obj(text)
    assert msg in str(e.value)
    assert "line " in str(e.value)


def _mesh_obj_text(n_verts: int, n_faces: int, seed: int) -> str:
    """Seeded .obj text with the vertex/face counts of a reference asset:
    a header comment, ``v``/``vt``/``vn`` lines, a group and smoothing
    line, and triangles in the three face-vertex forms (``i``, ``i/t``,
    ``i//n``)."""
    rng = np.random.default_rng(seed)
    lines = ["# generated mesh", "g mesh", "s 1"]
    for x, y, z in rng.uniform(-1, 1, (n_verts, 3)):
        lines.append(f"v {x:.6f} {y:.6f} {z:.6f}")
    for u, v in rng.uniform(0, 1, (n_verts, 2)):
        lines.append(f"vt {u:.6f} {v:.6f}")
    lines.append("vn 0 0 1")
    faces = rng.integers(1, n_verts + 1, (n_faces, 3))
    for k, (a, b, c) in enumerate(faces):
        form = k % 3
        if form == 0:
            lines.append(f"f {a} {b} {c}")
        elif form == 1:
            lines.append(f"f {a}/{a} {b}/{b} {c}/{c}")
        else:
            lines.append(f"f {a}//1 {b}//1 {c}//1")
    return "\n".join(lines) + "\n"


# vertex/face counts of the reference's pawn and bunny assets
# (test/Main.hs:323-344)
_ASSETS = {"pawn": (602, 1200, 1), "bunny": (2503, 4968, 2)}


def _asset_file(tmp_path, name):
    n_verts, n_faces, seed = _ASSETS[name]
    path = tmp_path / f"{name}.obj"
    path.write_text(_mesh_obj_text(n_verts, n_faces, seed))
    return str(path)


def test_read_reference_pawn(tmp_path):
    m = read_obj(_asset_file(tmp_path, "pawn"))
    assert m.vertices.shape[0] == 602
    assert m.faces.shape[0] == 1200


def test_read_reference_bunny(tmp_path):
    m = read_obj(_asset_file(tmp_path, "bunny"))
    assert m.vertices.shape[0] == 2503
    assert m.faces.shape[0] == 4968
    # every third face carries vt indices, the rest none
    assert (m.uv_faces[1::3] >= 0).all()
    assert (m.uv_faces[0::3] == -1).all()


def test_transform_vertices_and_bbox():
    m = parse_obj("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    import raytrace_tpu as rt
    m2 = m.transform_vertices(rt.compose(rt.translate([1, 0, 0]), rt.scale(2)))
    assert m2.vertices.tolist() == [[1, 0, 0], [3, 0, 0], [1, 2, 0]]
    lo, hi = m2.bounding_box()
    assert lo.tolist() == [1, 0, 0]
    assert hi.tolist() == [3, 2, 0]


# ---- native (C++) parser parity -------------------------------------------
# parse_obj() prefers native/objparse.cpp when g++ is available; the
# grammar must match the Python implementation exactly.

def _both(text):
    return parse_obj(text, native=True), parse_obj(text, native=False)


def _native_available():
    from raytrace_tpu.native import obj_lib
    return obj_lib() is not None


pytestmark_native = pytest.mark.skipif(
    not _native_available(), reason="no C++ toolchain")


@pytestmark_native
@pytest.mark.parametrize("text", [
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n",
    "v 0 0 0\r\nv 1 0 0\rv 0 1 0\nf -3 -2 -1",          # mixed newlines
    "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n",  # fan
    "v 1e-3 +2.5 -3E2 9\nv 4 5 6\nv 7 8 9\nvt .5\nf 1/1 2//9 3\n",
    "v 1_0 2_5.5 0\nv 4 5 6\nv 7 8 9\nf 1 2 3\n",   # PEP 515 separators
    "  v 9 9 9\nv 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n",  # leading ws ignored
    "v 0 0 0 # c\nv 1 0 0\nv 0 1 0\nvt 0 1 5\nf\t1/1  2/1\t3/1\n",
    "f 1 2 3\nv 0 0 0\nv 1 0 0\nv 0 1 0\n",             # forward refs
])
def test_native_matches_python(text):
    mn, mp = _both(text)
    np.testing.assert_array_equal(mn.vertices, mp.vertices)
    np.testing.assert_array_equal(mn.uv, mp.uv)
    np.testing.assert_array_equal(mn.faces, mp.faces)
    np.testing.assert_array_equal(mn.uv_faces, mp.uv_faces)


@pytestmark_native
@pytest.mark.parametrize("text", [
    "v 1 2\nf 1 1 1\n",
    "v 0x1 0 0\nf 1 1 1\n",                   # hex floats rejected
    "v _1 0 0\nf 1 1 1\n",                    # bad separator position
    "v 1_ 0 0\nf 1 1 1\n",
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nvt x\nf 1 2 3\n",
    "v 0 0 0\nf 1 2 3\n",
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2\n",
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 x\n",
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3/9\n",  # uv out of bounds
])
def test_native_errors_match_python(text):
    with pytest.raises(ObjParseError) as en:
        parse_obj(text, native=True)
    with pytest.raises(ObjParseError) as ep:
        parse_obj(text, native=False)
    assert str(en.value) == str(ep.value)


@pytestmark_native
@pytest.mark.parametrize("name", ["pawn", "bunny"])
def test_native_matches_python_on_reference_assets(tmp_path, name):
    with open(_asset_file(tmp_path, name)) as f:
        text = f.read()
    mn, mp = _both(text)
    np.testing.assert_array_equal(mn.vertices, mp.vertices)
    np.testing.assert_array_equal(mn.faces, mp.faces)
    np.testing.assert_array_equal(mn.uv_faces, mp.uv_faces)
