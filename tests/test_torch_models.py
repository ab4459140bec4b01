"""The PyTorch port's host modules against the JAX package's: scene loading,
the flat bake, the BVH bake, procedural scenes and `from_reference`.

These modules are numpy copies of the JAX package's, so every field must be
bit-equal (no tolerance)."""

import collections
import dataclasses
import os

import numpy as np
import pytest

from distributed_raytracer_tpu.models import scene as jscene
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch.models import bvh as tbvh
from distributed_raytracer_tpu_torch.models import scene as tscene
from distributed_raytracer_tpu_torch.utils import config as tconfig
from distributed_raytracer_tpu_torch.utils import scenes as tscenes
from tests.conftest import make_tetra_obj

LIGHTS = (
    '"lights": ['
    '{"pos": {"x": 3, "y": 4, "z": 5}, "col": {"r": 255, "g": 255, "b": 255}},'
    '{"pos": {"x": -4, "y": 2, "z": 3}, "col": {"r": 64, "g": 128, "b": 255}}]')
CAM = ('"cam": {"pos": {"x": 0.4, "y": 1.0, "z": 4.2},'
       '"dir": {"x": -0.1, "y": -0.25, "z": -1.0}, "fov": 1.0472}')
SCENES = {
    "tetra": '{"objs": [{"model": "tetra.obj", "pos": {"x": 0, "y": 0, '
             '"z": 0}}], ' + LIGHTS + ", " + CAM + "}",
    "two_tetra": '{"objs": [{"model": "tetra.obj", "pos": {"x": 0, "y": 0, '
                 '"z": 0}}, {"model": "tetra.obj", "pos": {"x": -1.6, '
                 '"y": 0.4, "z": -0.8}}], ' + LIGHTS + ", " + CAM + "}",
    "flat_tetra": '{"objs": [{"model": "flat.obj", "pos": {"x": 0.5, "y": 0, '
                  '"z": 0}}], ' + LIGHTS + ", " + CAM + "}",
}


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_models")
    make_tetra_obj(str(d / "tetra.obj"))
    make_tetra_obj(str(d / "flat.obj"), with_normals=False, with_mtl=False)
    for name, text in SCENES.items():
        (d / f"{name}.json").write_text(text)
    return d


def load_pair(scene_dir, name):
    """(JAX Scene, port Scene) of one test scene."""
    if name == "ico2":
        return jscenes.icosphere_scene(2), tscenes.icosphere_scene(2)
    path = str(scene_dir / f"{name}.json")
    return jscene.load_scene(path), tscene.load_scene(path)


def assert_tuple_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, f


@pytest.mark.parametrize("name", ["tetra", "two_tetra", "flat_tetra"])
def test_load_scene_matches(scene_dir, name):
    want, got = load_pair(scene_dir, name)
    assert sorted(got.meshes) == sorted(want.meshes)
    for k, wm in want.meshes.items():
        gm = got.meshes[k]
        for f in ("vertices", "normals", "faces_v", "faces_n", "face_mat"):
            np.testing.assert_array_equal(getattr(gm, f), getattr(wm, f))
        assert ([dataclasses.astuple(m) for m in gm.materials]
                == [dataclasses.astuple(m) for m in wm.materials])
    assert [(o.obj_id, o.model) for o in got.objects] == [
        (o.obj_id, o.model) for o in want.objects]
    for go, wo in zip(got.objects, want.objects):
        np.testing.assert_array_equal(go.pos, wo.pos)
    np.testing.assert_array_equal(got.light_pos, want.light_pos)
    np.testing.assert_array_equal(got.light_col, want.light_col)
    assert_tuple_equal(got.camera.to_arrays(), want.camera.to_arrays())


@pytest.mark.parametrize("name", ["tetra", "two_tetra", "flat_tetra", "ico2"])
def test_bake_matches(scene_dir, name):
    want, got = load_pair(scene_dir, name)
    assert_tuple_equal(got.bake(), want.bake())


@pytest.mark.parametrize("block_size", [64, 128])
@pytest.mark.parametrize("name", ["tetra", "two_tetra", "ico2"])
def test_bake_bvh_matches(scene_dir, name, block_size):
    want, got = load_pair(scene_dir, name)
    wa, wt = want.bake_bvh(block_size=block_size)
    ga, gt = got.bake_bvh(block_size=block_size)
    assert_tuple_equal(ga, wa)
    assert_tuple_equal(gt, wt)


def test_numpy_bvh_chain_matches(scene_dir):
    """The numpy chain behind bake_bvh (Morton order, gap-aligned slots,
    reorder, block bounds) equals the JAX package's, independently of the
    native library."""
    from distributed_raytracer_tpu.models import bvh as jbvh

    want, got = load_pair(scene_dir, "ico2")
    arrays = got.bake(tri_pad=64)
    p0 = np.asarray(arrays.p0, np.float64)
    cents = p0 + (np.asarray(arrays.e1, np.float64)
                  + np.asarray(arrays.e2, np.float64)) / 3.0
    codes = tbvh.morton_codes(cents)
    np.testing.assert_array_equal(codes, jbvh.morton_codes(cents))
    order = np.argsort(codes, kind="stable")
    slots = tbvh.gap_aligned_slots(codes[order], 64)
    np.testing.assert_array_equal(
        slots, jbvh.gap_aligned_slots(codes[order], 64))
    full = np.where(slots >= 0, order[np.maximum(slots, 0)], -1)
    assert_tuple_equal(tbvh.reorder_scene(arrays, full),
                       jbvh.reorder_scene(want.bake(tri_pad=64), full))
    assert_tuple_equal(tbvh.build_block_bvh(arrays, slots >= 0, 64),
                       jbvh.build_block_bvh(want.bake(tri_pad=64),
                                            slots >= 0, 64))


def test_from_reference_round_trip(scene_dir):
    want, got = load_pair(scene_dir, "two_tetra")
    ref = want.bake_bvh(block_size=64)
    arrays, tree = tscene.from_reference(*ref)
    assert isinstance(arrays, tscene.SceneArrays)
    assert isinstance(tree, tbvh.BlockBVH)
    assert_tuple_equal(arrays, got.bake_bvh(block_size=64)[0])
    for f in ref[0]._fields:
        np.testing.assert_array_equal(getattr(arrays, f), getattr(ref[0], f))
    assert tree.block_size == 64
    np.testing.assert_array_equal(tree.block_lo, ref[1].block_lo)
    # A wrong dtype or shape is refused, not converted.
    bad = ref[0]._replace(mat_id=ref[0].mat_id.astype(np.int64))
    with pytest.raises(ValueError, match="mat_id"):
        tscene.from_reference(bad, ref[1])
    bad = ref[1]._replace(block_lo=ref[1].block_lo[:-1])
    with pytest.raises(ValueError, match="block_lo"):
        tscene.from_reference(ref[0], bad)


def test_arrays_from_reference(scene_dir):
    """The flat JAX bake (no BVH), as the dense, sharded and ring renderers
    take it: every field bit-equal; a wrong field, dtype or shape is
    refused, not converted."""
    want, got = load_pair(scene_dir, "two_tetra")
    ref = want.bake()
    arrays = tscene.arrays_from_reference(ref)
    assert isinstance(arrays, tscene.SceneArrays)
    assert_tuple_equal(arrays, got.bake())
    bad = ref._replace(plane_d=ref.plane_d.astype(np.float64))
    with pytest.raises(ValueError, match="plane_d"):
        tscene.arrays_from_reference(bad)
    bad = ref._replace(light_col=ref.light_col[:1])
    with pytest.raises(ValueError, match="light_col"):
        tscene.arrays_from_reference(bad)
    other = collections.namedtuple("Other", ref._fields[:-1])
    with pytest.raises(ValueError, match="fields differ"):
        tscene.arrays_from_reference(other(*ref[:-1]))


def test_procedural_scenes_match():
    want, got = jscenes.icosphere_mesh(3), tscenes.icosphere_mesh(3)
    for f in ("vertices", "normals", "faces_v", "faces_n", "face_mat"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    jgrid = jscenes.instanced_grid(jscenes.icosphere_scene(1), 3)
    tgrid = tscenes.instanced_grid(tscenes.icosphere_scene(1), 3)
    assert_tuple_equal(tgrid.bake(), jgrid.bake())
    assert_tuple_equal(tgrid.camera.to_arrays(), jgrid.camera.to_arrays())


def test_config_matches():
    from distributed_raytracer_tpu.utils import config as jconfig

    assert (dataclasses.asdict(tconfig.DEFAULT_CONFIG)
            == dataclasses.asdict(jconfig.DEFAULT_CONFIG))
    for n in (968, 81_920, 999_999, 1_000_000, 5_242_880):
        assert tconfig.default_block_size(n) == jconfig.default_block_size(n)


def test_native_library_builds_once_for_two_processes(tmp_path):
    """Two processes that load the native library at once from a directory
    without it both get it: the port's loader builds under a lock file into
    a temporary name and renames it into place, so neither loads a
    half-written file. Runs on a copy of native/ (never the repository's
    own library)."""
    import shutil
    import subprocess
    import sys

    from distributed_raytracer_tpu_torch.models import native

    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("needs make and g++ to build the native library")
    src = os.path.join(os.path.dirname(native._NATIVE_DIR), "native")
    d = tmp_path / "native"
    d.mkdir()
    for name in ("Makefile", "drt_native.cpp"):
        shutil.copy(os.path.join(src, name), d / name)
    code = ("import sys; from distributed_raytracer_tpu_torch.models import "
            "native; lib = native.open_library(sys.argv[1]); "
            "print('ok' if lib is not None and lib.drt_morton_argsort "
            "else 'none')")
    root = os.path.dirname(src)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(d)], cwd=root,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert outs == ["ok", "ok"]
    left = sorted(os.listdir(d))
    assert "libdrt_native.so" in left
    assert not [n for n in left if n.startswith(native._TMP_PREFIX)]


def test_native_library_builds_past_a_failing_cxx(tmp_path):
    """With CXX in the environment naming a compiler that fails (as a g++
    without OpenMP's libgomp.spec does), the port's loader builds the
    library with the PATH's g++ instead. Runs on a copy of native/."""
    import shutil
    import subprocess
    import sys

    from distributed_raytracer_tpu_torch.models import native

    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("needs make and g++ to build the native library")
    src = os.path.join(os.path.dirname(native._NATIVE_DIR), "native")
    d = tmp_path / "native"
    d.mkdir()
    for name in ("Makefile", "drt_native.cpp"):
        shutil.copy(os.path.join(src, name), d / name)
    code = ("import sys; from distributed_raytracer_tpu_torch.models import "
            "native; lib = native.open_library(sys.argv[1]); "
            "print('ok' if lib is not None and lib.drt_morton_argsort "
            "else 'none')")
    env = dict(os.environ, CXX="false")
    out = subprocess.run([sys.executable, "-c", code, str(d)],
                         cwd=os.path.dirname(src), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "ok", out.stderr
    assert "libdrt_native.so" in os.listdir(d)
