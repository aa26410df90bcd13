"""The port's command line (``python -m swift_png_tpu_torch``) against the
JAX package's (``python -m swift_png_tpu``): every subcommand run in
process through each package's ``main(argv)``, each in a directory of its
own holding the same input files written here, with relative paths.  Exit
codes, standard output and every file in the directory afterwards must be
equal.  Both packages' native libraries are on or off together."""

import gzip as pygzip
import os
import zlib

import numpy as np
import pytest

import conftest  # noqa: F401

import swift_png_tpu.native as jax_native
import swift_png_tpu_torch._host.native as torch_native
from swift_png_tpu.__main__ import main as jax_main
from swift_png_tpu_torch import png as tpng
from swift_png_tpu_torch.__main__ import main as torch_main
from swift_png_tpu_torch.png import parsing as tparsing


@pytest.fixture(params=["off", "on"])
def native(request, monkeypatch):
    if request.param == "off":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(torch_native, "available", lambda: False)
    elif not (jax_native.available() and torch_native.available()):
        pytest.fail("a native library did not build")
    return request.param


def _metadata():
    P = tparsing
    return tpng.Metadata(
        time=P.TimeModified(2024, 2, 29, 23, 59, 60),
        gamma=P.Gamma(45455),
        physical_dimensions=P.PhysicalDimensions((2835, 3780), "meter"),
        significant_bits=P.SignificantBits("rgb", (5, 6, 5)),
        suggested_palettes=[P.SuggestedPalette(
            "eight", 8, [((i, 2, 3, 4), 9 - i) for i in range(9)])],
        text=[P.Text(True, ("Title", "Titel"), "de", "über alles"),
              P.Text(False, ("Author", ""), "", "someone")],
        application=[("prVt", bytes(range(20)))])


def _inputs():
    """``{name: bytes}``: the files every subcommand reads."""
    rng = np.random.default_rng(15)
    rgb = rng.integers(0, 256, (16, 16, 4)).astype(np.uint8)
    rgb[..., 3] = 255
    smooth = np.repeat(np.arange(24, dtype=np.uint8)[None, :] * 9, 24, 0)
    smooth = np.stack([smooth, smooth.T, smooth // 2,
                       np.full_like(smooth, 255)], -1)
    pal = tuple((i * 17, 255 - i * 17, i * 5, 255) for i in range(16))
    idx = np.array(pal, np.uint8)[rng.integers(0, 16, (10, 12))]

    def png(px, kind, interlaced=False, metadata=None, palette=(),
            index=False):
        img = tpng.Image.pack(px, tpng.Layout(tpng.Format(kind, palette),
                                              interlaced), metadata)
        return img.compress_bytes(level=6, engine="python", index=index)

    text = b"".join(b"line %d of the gzip input\n" % (i % 37)
                    for i in range(120))
    return {
        "rgb.png": png(rgb, "rgb8", metadata=_metadata()),
        "smooth.png": png(smooth, "rgba8"),
        "indexed.png": png(idx, "indexed4", palette=pal),
        "adam7.png": png(rgb, "rgb8", interlaced=True),
        "cgbi.png": png(rgb, "bgra8"),
        "indexed_already.png": png(smooth, "rgba8", index=True),
        "text.txt": text,
        "text.gz": pygzip.compress(text, 6, mtime=0),
    }


def _run(main, root, files, argv_list, capsys, monkeypatch):
    os.makedirs(root)
    for name, blob in files.items():
        with open(os.path.join(root, name), "wb") as f:
            f.write(blob)
    monkeypatch.chdir(root)
    results = []
    for argv in argv_list:
        rc = main(argv)
        results.append((argv, rc, capsys.readouterr().out))
    tree = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            tree[name] = f.read()
    return results, tree


def _both(tmp_path, files, argv_list, capsys, monkeypatch):
    j = _run(jax_main, str(tmp_path / "jax"), files, argv_list, capsys,
             monkeypatch)
    t = _run(torch_main, str(tmp_path / "torch"), files, argv_list, capsys,
             monkeypatch)
    assert t[0] == j[0]
    assert t[1].keys() == j[1].keys()
    for name in j[1]:
        assert t[1][name] == j[1][name], name
    return t


@pytest.mark.parametrize("name", ["rgb.png", "smooth.png", "indexed.png",
                                  "adam7.png", "cgbi.png",
                                  "indexed_already.png"])
def test_inspect_and_decode(name, tmp_path, capsys, monkeypatch):
    (results, tree) = _both(tmp_path, _inputs(),
                            [["inspect", name], ["decode", name, "out.rgba"]],
                            capsys, monkeypatch)
    assert [rc for _, rc, _ in results] == [0, 0]
    assert "PNG image" in results[0][2]
    img = tpng.Image.decompress_bytes(tree[name])
    assert tree["out.rgba"] == img.unpack_rgba8().tobytes()


@pytest.mark.parametrize("level,index", [(6, False), (9, True), (1, True)])
@pytest.mark.parametrize("name", ["rgb.png", "indexed.png", "adam7.png",
                                  "cgbi.png"])
def test_recode(name, level, index, native, tmp_path, capsys, monkeypatch):
    argv = ["recode", name, "re.png", "--level", str(level)]
    if index:
        argv.append("--index")
    (results, tree) = _both(tmp_path, _inputs(), [argv], capsys, monkeypatch)
    assert results[0][1] == 0
    a = tpng.Image.decompress_bytes(tree[name]).unpack_rgba8()
    b = tpng.Image.decompress_bytes(tree["re.png"]).unpack_rgba8()
    assert np.array_equal(a, b)


def test_index_and_its_refusals(native, tmp_path, capsys, monkeypatch):
    argv_list = [["index", "smooth.png", "ix.png"],
                 ["index", "rgb.png", "--ob", "64"],
                 ["index", "indexed_already.png"],
                 ["index", "cgbi.png", "x.png"],
                 ["index", "adam7.png", "y.png"],
                 ["index", "ix.png"]]
    (results, tree) = _both(tmp_path, _inputs(), argv_list, capsys,
                            monkeypatch)
    assert [rc for _, rc, _ in results] == [0, 0, 0, 1, 1, 0]
    assert "already indexed" in results[2][2]
    assert "CgBI" in results[3][2] and "interlaced" in results[4][2]
    assert "already indexed" in results[5][2]
    assert b"spIx" in tree["ix.png"] and b"spIx" in tree["rgb.png"]
    assert "x.png" not in tree and "y.png" not in tree
    for name in ("ix.png", "rgb.png"):
        # the chunk goes in before IEND; every other chunk is copied
        img = tpng.Image.decompress_bytes(tree[name])
        assert img.metadata.application[-1][0] == "spIx"


@pytest.mark.parametrize("level", [0, 6, 9])
def test_gzip_and_gunzip(level, tmp_path, capsys, monkeypatch):
    argv_list = [["gzip", "text.txt", "--level", str(level)],
                 ["gzip", "rgb.png", "rgb.bin", "--level", str(level)],
                 ["gunzip", "text.txt.gz", "back.txt"],
                 ["gunzip", "text.gz"],
                 ["gunzip", "rgb.bin"]]
    (results, tree) = _both(tmp_path, _inputs(), argv_list, capsys,
                            monkeypatch)
    assert [rc for _, rc, _ in results] == [0] * 5
    assert tree["back.txt"] == tree["text.txt"]
    assert tree["text"] == tree["text.txt"]
    assert tree["rgb.bin.out"] == tree["rgb.png"]
    assert zlib.decompress(tree["text.txt.gz"][10:], -15) == tree["text.txt"]
