"""The port's host data library against the JAX package's, on the CPU.

``myconvnet_tpu_torch/data/native_loader.py`` builds its own copy of the
host library (``csrc/host/dataloader.cc``) under ``build/host/``; the JAX
package builds ``native/dataloader.cc``.  Both from the same source with
the same flags, against the same libjpeg and libpng, so a decode is held
bit for bit: JPEGs at each DCT prescale libjpeg takes (1, 1/2, 1/4, 1/8),
a grayscale, a progressive and an exact-size decode, a PNG given to the
JPEG path (both decode it through Pillow); PNGs in "rgb" and "raw" mode
(palette indices), None on junk.  The shuffle and the gather are equal;
the host normalize is within 1 float32 ulp.  The fixtures are the files of
``tests/fixtures/torch_io/`` (``tests/test_torch_file_io.py`` writes
them).
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from myconvnet_tpu.data import native_loader as jnl
from myconvnet_tpu_torch.data import native_loader as tnl

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_io")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _blob(*parts):
    with open(os.path.join(FIXTURES, *parts), "rb") as f:
        return f.read()


def _png(arr, mode=None, **kw):
    from PIL import Image
    img = Image.fromarray(arr) if mode is None else \
        Image.frombytes(mode, arr.shape[1::-1], arr.tobytes())
    if mode == "P":
        img.putpalette(list(np.random.RandomState(0).randint(
            0, 256, 768).astype(int)))
    buf = io.BytesIO()
    img.save(buf, "PNG", **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def both_native():
    """Both packages' libraries are built with JPEG and PNG here."""
    assert tnl.backend()["jpeg"] and tnl.backend()["png"]
    assert jnl.native_jpeg_available() and jnl.native_png_available()


def test_backend_names_the_library_built_under_build_host(both_native):
    info = tnl.backend()
    assert set(info) == {"jpeg", "png", "built"}
    built = os.path.relpath(info["built"], ROOT)
    assert built.startswith(os.path.join("build", "host")) and \
        built.endswith("libmcn_data.so"), built
    assert "native" not in built.split(os.sep)


# (fixture, raw_hw): 640x480 lands at each DCT prescale (the smallest 1/d
# whose image still covers raw_hw), exactly at 1/8 at 60x80 (no resize)
JPEG_CASES = {
    "prescale_1": ("img_640x480.jpg", (256, 256)),
    "prescale_1/2": ("img_640x480.jpg", (200, 200)),
    "prescale_1/4": ("img_640x480.jpg", (100, 120)),
    "prescale_1/8": ("img_640x480.jpg", (56, 56)),
    "exact_size": ("img_640x480.jpg", (60, 80)),
    "grayscale": ("img_gray_500x375.jpg", (224, 224)),
    "progressive": ("img_progressive_400x300.jpg", (128, 96)),
    "tall": ("img_281x500.jpg", (256, 256)),
    "upscale": ("img_500x333.jpg", (400, 600)),
}


@pytest.mark.parametrize("case", list(JPEG_CASES))
def test_decode_jpeg_batch_is_bit_exact(both_native, case):
    name, raw_hw = JPEG_CASES[case]
    blobs = [_blob("imagenet", name)] * 3
    got = tnl.decode_jpeg_batch(blobs, raw_hw, n_threads=2)
    want = jnl.decode_jpeg_batch(blobs, raw_hw, n_threads=2)
    assert got.shape == (3, *raw_hw, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(got[0], got[2])
    assert got.std() > 10   # the picture, not a blank


def test_decode_jpeg_batch_sends_a_png_through_pillow(both_native):
    """A PNG (another container) fails in libjpeg; both packages decode it
    through Pillow's cover-resize, the rest of the batch natively."""
    rgb = np.random.RandomState(1).randint(0, 256, (50, 70, 3), np.uint8)
    blobs = [_blob("imagenet", "img_500x375.jpg"), _png(rgb),
             _blob("imagenet", "img_375x500.jpg")]
    got = tnl.decode_jpeg_batch(blobs, (32, 40))
    np.testing.assert_array_equal(got, jnl.decode_jpeg_batch(blobs, (32, 40)))
    from PIL import Image
    from myconvnet_tpu_torch.data.pipeline import cover_resize_center_crop
    np.testing.assert_array_equal(
        got[1], cover_resize_center_crop(Image.fromarray(rgb), (32, 40)))


def test_decode_jpeg_batch_of_many_images_over_threads(both_native):
    """Every fixture JPEG in one batch, over 1 and 5 threads: equal."""
    names = sorted(os.listdir(os.path.join(FIXTURES, "imagenet")))
    blobs = [_blob("imagenet", n) for n in names] * 2
    one = tnl.decode_jpeg_batch(blobs, (64, 64), n_threads=1)
    np.testing.assert_array_equal(
        one, tnl.decode_jpeg_batch(blobs, (64, 64), n_threads=5))
    np.testing.assert_array_equal(one, jnl.decode_jpeg_batch(blobs, (64, 64)))


def _png_cases():
    rng = np.random.RandomState(2)
    idx = rng.randint(0, 21, (30, 40)).astype(np.uint8)
    idx[:2] = 255
    return {
        "voc_palette": _blob("voc", "SegmentationClass", "2007_000032.png"),
        "palette": _png(idx, "P"),
        "palette_4bit": _png(idx % 16, "P", bits=4),
        "gray": _png(rng.randint(0, 256, (20, 30), np.uint8)),
        "rgb": _png(rng.randint(0, 256, (20, 30, 3), np.uint8)),
        "rgba": _png(rng.randint(0, 256, (20, 30, 4), np.uint8)),
        "gray16": _png(rng.randint(0, 60000, (20, 30)).astype(np.uint16)),
    }


PNG_CASES = _png_cases()


@pytest.mark.parametrize("mode", ["rgb", "raw"])
@pytest.mark.parametrize("case", list(PNG_CASES))
def test_decode_png_is_bit_exact(both_native, case, mode):
    """Equal, or None from both where the native path declines (raw mode
    on truecolor or 16-bit images)."""
    blob = PNG_CASES[case]
    got, want = tnl.decode_png(blob, mode), jnl.decode_png(blob, mode)
    if want is None:
        assert got is None and (mode, case) in {
            ("raw", "rgb"), ("raw", "rgba"), ("raw", "gray16")}
        return
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_decode_png_raw_gives_the_palette_indices(both_native):
    from PIL import Image
    blob = PNG_CASES["voc_palette"]
    raw = tnl.decode_png(blob, "raw")
    np.testing.assert_array_equal(raw, np.asarray(Image.open(io.BytesIO(
        blob))))
    assert 255 in raw and raw.max() == 255


@pytest.mark.parametrize("blob", [b"", b"junk", b"\x89PNG\r\n\x1a\n",
                                  PNG_CASES["gray"][:60]],
                         ids=["empty", "junk", "signature_only", "truncated"])
def test_decode_png_of_junk_is_none(both_native, blob):
    for mode in ("rgb", "raw"):
        assert tnl.decode_png(blob, mode) is None
        assert jnl.decode_png(blob, mode) is None


@pytest.mark.parametrize("seed,n", [(0, 1), (0, 10), (7, 1000),
                                    (2 ** 40 + 3, 257)])
def test_shuffle_indices_equal(seed, n):
    got = tnl.shuffle_indices(seed, n)
    np.testing.assert_array_equal(got, jnl.shuffle_indices(seed, n))
    np.testing.assert_array_equal(np.sort(got), np.arange(n))


@pytest.mark.parametrize("kind", ["uint8", "uint8_threads", "float32",
                                  "strided"])
def test_gather_batch_equal(kind):
    rng = np.random.RandomState(3)
    pool = rng.randint(0, 256, (40, 6, 5, 3), np.uint8)
    if kind == "float32":
        pool = pool.astype(np.float32)
    if kind == "strided":
        pool = pool[:, ::2]
    idx = rng.randint(0, len(pool), 33)
    threads = 4 if kind == "uint8_threads" else 1
    got = tnl.gather_batch(pool, idx, n_threads=threads)
    np.testing.assert_array_equal(got, jnl.gather_batch(pool, idx, threads))
    np.testing.assert_array_equal(got, pool[idx])
    assert got.flags.c_contiguous


def test_gather_batch_refuses_indices_outside_the_pool():
    pool = np.zeros((4, 2, 2, 3), np.uint8)
    with pytest.raises(IndexError):
        tnl.gather_batch(pool, np.array([0, 4]))


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (64, 64, 64, 3),
                                   (3, 4, 4, 1)])
def test_normalize_u8_host_within_one_ulp(shape):
    """(x / 255 - mean) / std: the native loop and the numpy fallback
    (the large batch runs threaded) within 1 float32 ulp of JAX's."""
    c = shape[-1]
    x = np.random.RandomState(4).randint(0, 256, shape, np.uint8)
    mean, std = (0.485, 0.456, 0.406)[:c], (0.229, 0.224, 0.225)[:c]
    got = tnl.normalize_u8_host(x, mean, std, n_threads=3)
    want = jnl.normalize_u8_host(x, mean, std)
    assert got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    np.testing.assert_allclose(
        got, (x / 255.0 - np.asarray(mean)) / np.asarray(std), atol=1e-5)


BUILD_SCRIPT = """
import sys
from pathlib import Path
from myconvnet_tpu_torch.data import native_loader as nl
nl.BUILD_DIR = Path(sys.argv[1])
info = nl.backend()
assert info["built"] and info["built"].startswith(sys.argv[1]), info
assert sorted(nl.shuffle_indices(1, 5)) == [0, 1, 2, 3, 4]
print(info["built"])
"""


def test_the_library_builds_into_a_fresh_directory_from_two_processes(
        tmp_path):
    """Two processes build into one empty directory at once: each loads a
    whole library (written to a temporary name, then renamed)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT,
                               str(tmp_path)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    built = {o.strip() for o, _ in outs}
    assert len(built) == 1
    (path,) = built
    assert os.path.exists(path)
    assert [f for f in os.listdir(os.path.dirname(path))] == \
        ["libmcn_data.so"]


def _imports(path):
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_chip_smoke_imports_no_jax():
    """``chip_smoke.py`` runs on the card's machine without JAX: it
    imports neither ``jax`` nor the JAX package."""
    names = list(_imports(os.path.join(ROOT, "chip_smoke.py")))
    assert "torch" in names
    assert not [n for n in names if n.split(".")[0] in
                ("jax", "jaxlib", "myconvnet_tpu")]


def test_port_names_no_path_under_the_jax_packages_native_directory():
    """The port builds and loads its own host library: no string in its
    sources names the JAX package's ``native/`` directory or its
    library."""
    import ast
    import pathlib
    files = sorted(pathlib.Path(ROOT, "myconvnet_tpu_torch").rglob("*.py"))
    assert files
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str):
                v = node.value
                assert v != "native" and "native/" not in v and \
                    "native/dataloader.cc" not in v, (f.name, v)
