"""F8: the host half of the nvJPEG decode, held to libjpeg bit for bit.

On the card's machine the port decodes JPEGs through nvJPEG
(``csrc/nvjpeg_compat/``). For a subsampled image nvJPEG returns the YCbCr
planes, and ``csrc/nvjpeg_compat/libjpeg_upsample.cc`` upsamples the chroma
with libjpeg's triangle filter and converts to RGB with libjpeg's fixed-point
arithmetic. Here that file is built with g++ beside
``csrc/nvjpeg_compat/libjpeg_planes.cc``, which hands it libjpeg's own planes
(``raw_data_out``: after the IDCT, before upsampling and colour conversion),
and its RGB is held to libjpeg's decode at 0 levels: the committed reference
decodes of ``tests/fixtures/torch_jpeg`` and fresh ones of PIL-encoded images
at sizes where the filter's edge cases lie.
"""

import ctypes
import io
import os
import shutil
import subprocess

import numpy as np
import pytest
from PIL import Image

from yet_another_mobilenet_series_tpu_torch.data import jpeg_corpus
from yet_another_mobilenet_series_tpu_torch.ops import host_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPAT = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "csrc", "nvjpeg_compat")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_jpeg")
U8P = ctypes.POINTER(ctypes.c_uint8)
SUBSAMPLING = {(2, 2): "4:2:0", (2, 1): "4:2:2", (1, 1): "4:4:4"}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build csrc/nvjpeg_compat/libjpeg_upsample.cc")
    out = str(tmp_path_factory.mktemp("chroma") / "libchroma.so")
    cmd = ["g++", *host_build.CXX_FLAGS, "-o", out, os.path.join(COMPAT, "libjpeg_upsample.cc"),
           os.path.join(COMPAT, "libjpeg_planes.cc"), "-ljpeg"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lib = ctypes.CDLL(out)
    lib.yamt_ycc_to_rgb.restype = ctypes.c_int
    lib.yamt_ycc_to_rgb.argtypes = [U8P, ctypes.c_int, U8P, U8P, ctypes.c_int] + [ctypes.c_int] * 7 + [U8P]
    for name in ("yamt_libjpeg_info", "yamt_libjpeg_planes", "yamt_libjpeg_rgb"):
        getattr(lib, name).restype = ctypes.c_int
    lib.yamt_libjpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_ulong, ctypes.POINTER(ctypes.c_int)]
    lib.yamt_libjpeg_planes.argtypes = [ctypes.c_char_p, ctypes.c_ulong, ctypes.POINTER(ctypes.c_void_p)]
    lib.yamt_libjpeg_rgb.argtypes = [ctypes.c_char_p, ctypes.c_ulong, ctypes.c_int, U8P]
    return lib


def _info(lib, data: bytes) -> dict:
    a = (ctypes.c_int * 15)()
    assert lib.yamt_libjpeg_info(data, len(data), a) == 0
    comps = [{"h": a[3 + 4 * c], "v": a[4 + 4 * c], "w": a[5 + 4 * c], "rows": a[6 + 4 * c]} for c in range(a[2])]
    return {"width": a[0], "height": a[1], "comps": comps}


def _planes(lib, data: bytes, info: dict) -> list[np.ndarray]:
    planes = [np.zeros((c["rows"], c["w"]), np.uint8) for c in info["comps"]]
    ptrs = (ctypes.c_void_p * 3)(*[p.ctypes.data for p in planes])
    assert lib.yamt_libjpeg_planes(data, len(data), ptrs) == 0
    return planes


def _libjpeg_rgb(lib, data: bytes, info: dict, fancy: bool = True) -> np.ndarray:
    out = np.zeros((info["height"], info["width"], 3), np.uint8)
    assert lib.yamt_libjpeg_rgb(data, len(data), int(fancy), out.ctypes.data_as(U8P)) == 0
    return out


def _filtered(lib, data: bytes, fancy: bool = True) -> np.ndarray:
    """libjpeg's planes of ``data`` through libjpeg_upsample.cc."""
    info = _info(lib, data)
    y, cb, cr = _planes(lib, data, info)
    luma, chroma = info["comps"][0], info["comps"][1]
    hf, vf = luma["h"] // chroma["h"], luma["v"] // chroma["v"]
    out = np.zeros((info["height"], info["width"], 3), np.uint8)
    rc = lib.yamt_ycc_to_rgb(y.ctypes.data_as(U8P), y.shape[1], cb.ctypes.data_as(U8P), cr.ctypes.data_as(U8P),
                             cb.shape[1], info["width"], info["height"], cb.shape[1], cb.shape[0], hf, vf,
                             int(fancy), out.ctypes.data_as(U8P))
    assert rc == 0
    return out


@pytest.mark.parametrize("name,sub", [(r[0], r[3]) for r in jpeg_corpus.REFERENCE], ids=[r[0] for r in
                                                                                       jpeg_corpus.REFERENCE])
def test_filter_reproduces_the_committed_libjpeg_decodes(lib, name, sub):
    with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as f:
        data = f.read()
    luma, chroma = _info(lib, data)["comps"][:2]
    assert SUBSAMPLING[(luma["h"] // chroma["h"], luma["v"] // chroma["v"])] == sub
    want = np.load(os.path.join(FIXTURES, f"{name}.npy"))
    np.testing.assert_array_equal(_filtered(lib, data), want)


# (width, height): chroma rows of 1, 2 and 3 samples (libjpeg replicates at
# most 2, filters from 3), odd sizes, and a corpus size with an odd height
SIZES = [(1, 1), (2, 3), (3, 2), (4, 5), (5, 4), (6, 7), (17, 15), (75, 53), (33, 64), (500, 375)]


@pytest.mark.parametrize("fancy", [True, False], ids=["fancy", "replicated"])
@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4"])
@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_filter_equals_libjpeg_at_edge_sizes(lib, sub, size, fancy):
    """Fancy: libjpeg's defaults; replicated: do_fancy_upsampling off (its
    merged upsampler), what the reduced-scale decode box-averages."""
    w, h = size
    pixels = np.random.default_rng([w, h, len(sub)]).integers(0, 256, (h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="JPEG", quality=90, subsampling=sub)
    data = buf.getvalue()
    np.testing.assert_array_equal(_filtered(lib, data, fancy), _libjpeg_rgb(lib, data, _info(lib, data), fancy))


def test_filter_refuses_planes_outside_its_contract(lib):
    y = np.zeros((4, 6), np.uint8)
    c = np.zeros((2, 3), np.uint8)
    out = np.zeros((4, 6, 3), np.uint8)

    def call(width, height, cw, ch, hf, vf, y_pitch=6, c_pitch=3):
        return lib.yamt_ycc_to_rgb(y.ctypes.data_as(U8P), y_pitch, c.ctypes.data_as(U8P), c.ctypes.data_as(U8P),
                                   c_pitch, width, height, cw, ch, hf, vf, 1, out.ctypes.data_as(U8P))

    assert call(6, 4, 3, 2, 2, 2) == 0
    assert call(6, 4, 3, 2, 3, 2) == -1  # only 1 or 2
    assert call(6, 4, 2, 2, 2, 2) == -1  # cw is not ceil(width / hf)
    assert call(6, 4, 3, 1, 2, 2) == -1  # ch is not ceil(height / vf)
    assert call(6, 4, 3, 2, 2, 2, y_pitch=5) == -1
    assert call(6, 4, 3, 2, 2, 2, c_pitch=2) == -1
    assert call(0, 4, 0, 2, 2, 2) == -1
