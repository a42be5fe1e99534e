"""Settings parser and PNG codec that replace PyYAML and Pillow on the main
path, the compile-cache location, and chip_smoke.py's device check."""

import glob
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from eorb_slam_tpu.io import config, png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def _run(code_or_args, env_extra=None, unset=(), cwd=ROOT, timeout=300,
         repo_on_path=True):
    env = dict(os.environ)
    for k in unset:
        env.pop(k, None)
    env.update(env_extra or {})
    if repo_on_path:
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    args = (code_or_args if isinstance(code_or_args, list)
            else ["-c", code_or_args])
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=timeout)


# ------------------------------------------------------------ settings


def _yaml_view(v):
    """PyYAML (YAML 1.1) reads ``1.0e9`` as a string; FileStorage and this
    parser read it as a real. Compare on the FileStorage reading."""
    if isinstance(v, dict):
        return {k: _yaml_view(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_yaml_view(x) for x in v]
    if isinstance(v, str):
        try:
            return float(v) if any(c.isdigit() for c in v) else v
        except ValueError:
            return v
    return v


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_parser_matches_pyyaml_on_configs(path):
    yaml = pytest.importorskip("yaml")
    text = open(path).read()
    body = text.split("\n", 1)[1] if text.startswith("%YAML") else text
    want = _yaml_view(yaml.safe_load(body))
    got = config.parse_fs_yaml(text)
    assert got == want
    assert {type(v) for v in got.values()} <= {str, int, float, list}


def test_parser_reference_layout():
    text = """%YAML:1.0
---
# OpenCV FileStorage layout of the reference's settings files
Camera.type: "PinHole"   # trailing comment
Camera.fx: 458.654
Camera.k1: -2.917e-01
Viewer:
  enabled: true
  names: ['a', "b # not a comment", it's]
DS.Seq.names:
- "MH_01"
-   MH_02
Tbc: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
         -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]
Empty:
Count: 12
"""
    d = config.parse_fs_yaml(text)
    assert d["Camera.type"] == "PinHole"
    assert d["Camera.fx"] == 458.654 and d["Camera.k1"] == -0.2917
    assert d["Viewer"] == {"enabled": True,
                           "names": ["a", "b # not a comment", "it's"]}
    assert d["DS.Seq.names"] == ["MH_01", "MH_02"]
    tbc = d["Tbc"]
    assert (tbc["rows"], tbc["cols"], tbc["dt"]) == (4, 4, "f")
    assert len(tbc["data"]) == 16 and tbc["data"][-1] == 1.0
    assert d["Empty"] is None and d["Count"] == 12


def test_opencv_matrix_reaches_settings(tmp_path):
    p = tmp_path / "vi.yaml"
    p.write_text('%YAML:1.0\n---\nDS.Sensor.config: "mono_im_imu"\n'
                 "Tbc: !!opencv-matrix\n  rows: 4\n  cols: 4\n  dt: f\n"
                 "  data: [1, 0, 0, 0.1,\n          0, 1, 0, 0.2,\n"
                 "          0, 0, 1, 0.3,\n          0, 0, 0, 1]\n")
    s = config.load_settings(str(p))
    assert s.sensor is config.SensorConfig.IMU_MONOCULAR
    np.testing.assert_allclose(s.imu.Tbc[:3, 3], [0.1, 0.2, 0.3])


@pytest.mark.parametrize("text", [
    "a: [1, 2\n",               # unterminated flow list
    "a: {b: 1}\n",              # flow map
    "a: 1\n   b: 2\n",          # stray indentation
    "- x: 1\n",                 # map inside a list
])
def test_parser_rejects_unsupported(text):
    with pytest.raises(ValueError):
        config.parse_fs_yaml(text)


# ----------------------------------------------------------------- PNG


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", [(480, 752), (7, 3), (1, 1)])
def test_png_round_trip(tmp_path, dtype, shape):
    rng = np.random.default_rng(0)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    p = str(tmp_path / "x.png")
    png.write_png(p, img)
    out = png.read_png(p)
    assert out.dtype == dtype
    np.testing.assert_array_equal(out, img)


def _filter_row(ftype, row, prev, bpp):
    """PNG spec §9 forward filters (test-side encoder)."""
    row, prev = row.astype(np.int64), prev.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(row)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = prev
    elif ftype == 3:
        pred = (left + prev) >> 1
    else:
        p = left + prev - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prev, ul))
    return ((row - pred) & 0xFF).astype(np.uint8)


def _write_filtered(path, img, ftypes, ctype):
    h, w = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    rows = img.astype(img.dtype.newbyteorder(">")).view(np.uint8)
    rows = rows.reshape(h, -1)
    bpp = rows.shape[1] // w
    raw, prev = b"", np.zeros(rows.shape[1], np.uint8)
    for r in range(h):
        f = ftypes[r % len(ftypes)]
        raw += bytes([f]) + _filter_row(f, rows[r], prev, bpp).tobytes()
        prev = rows[r]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                           0, 0, 0)))
        # split IDAT in two: readers must concatenate
        z = zlib.compress(raw)
        f.write(chunk(b"IDAT", z[:5]) + chunk(b"IDAT", z[5:]))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["grey8", "grey16", "rgb8"])
@pytest.mark.parametrize("ftypes", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=lambda f: "f" + "".join(map(str, f)))
def test_png_decodes_every_filter(tmp_path, kind, ftypes):
    rng = np.random.default_rng(len(ftypes))
    yy, xx = np.mgrid[0:23, 0:37]
    base = (np.sin(xx / 5.0) + np.cos(yy / 3.0)) * 60 + 128
    noise = rng.normal(0, 20, base.shape)
    if kind == "grey16":
        img = ((base + noise) * 200).clip(0, 65535).astype(np.uint16)
        want, ctype = img, 0
    elif kind == "grey8":
        img = (base + noise).clip(0, 255).astype(np.uint8)
        want, ctype = img, 0
    else:
        img = np.stack([(base + noise * k).clip(0, 255) for k in (1, -1, 2)],
                       -1).astype(np.uint8)
        p = img.astype(np.uint64)
        want = ((p[..., 0] * 19595 + p[..., 1] * 38470 + p[..., 2] * 7471
                 + 0x8000) >> 16).astype(np.uint8)
        ctype = 2
    path = str(tmp_path / "f.png")
    _write_filtered(path, img, ftypes, ctype)
    np.testing.assert_array_equal(png.read_png(path), want)


@pytest.mark.parametrize("mode", ["L", "I;16", "RGB"])
def test_png_reads_pillow_files(tmp_path, mode):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:60, 0:90]
    smooth = (np.sin(xx / 7.0) + np.cos(yy / 5.0)) * 60 + 128
    path = str(tmp_path / "p.png")
    if mode == "L":
        arr = (smooth + rng.normal(0, 3, smooth.shape)).clip(0, 255)
        Image.fromarray(arr.astype(np.uint8)).save(path)
    elif mode == "I;16":
        arr = (smooth * 250).astype(np.uint16)
        Image.frombytes("I;16", arr.shape[::-1], arr.tobytes()).save(path)
    else:
        arr = np.stack([smooth, 255 - smooth, smooth / 2], -1)
        Image.fromarray(arr.astype(np.uint8), "RGB").save(path)
    want = np.asarray(Image.open(path).convert("L") if mode == "RGB"
                      else Image.open(path))
    np.testing.assert_array_equal(png.read_png(path), want)


def test_png_rejects_unsupported(tmp_path):
    p = tmp_path / "bad.png"
    p.write_bytes(b"not a png")
    with pytest.raises(ValueError):
        png.read_png(str(p))
    with pytest.raises(ValueError):
        png.write_png(str(p), np.zeros((4, 4), np.float32))


def test_main_path_without_yaml_or_pillow(tmp_path):
    """Settings and a EuRoC frame load with yaml and PIL unimportable."""
    seq = tmp_path / "ds" / "seq" / "mav0"
    (seq / "cam0" / "data").mkdir(parents=True)
    img = (np.arange(48 * 64) % 251).astype(np.uint8).reshape(48, 64)
    png.write_png(str(seq / "cam0" / "data" / "1000000000.png"), img)
    (seq / "cam0" / "data.csv").write_text(
        "#timestamp [ns],filename\n1000000000,1000000000.png\n")
    cfg = tmp_path / "s.yaml"
    cfg.write_text(open(CONFIGS[0]).read().replace(
        "data_synth/euroc", str(tmp_path / "ds")))
    code = f"""
import sys
sys.modules["yaml"] = None
sys.modules["PIL"] = None
from eorb_slam_tpu.apps import run_slam
from eorb_slam_tpu.io import config, datasets
st = config.load_settings({str(cfg)!r})
seq = datasets.load_sequence(st.dataset.format, st.dataset.root, "seq",
                             ts_factor=st.dataset.ts_factor)
im = seq.image(0)
assert "yaml" not in sys.modules or sys.modules["yaml"] is None
print(st.cam.width, im.shape, float(im.max()))
"""
    r = _run(code, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split() == ["752", "(48,", "64)",
                                str(float(np.float32(250 / 255.0)))]


# ------------------------------------------------------- compile cache


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_location(tmp_path, env_dir):
    code = ("import jax; from eorb_slam_tpu.utils import compile_cache as c;"
            "d = c.enable(); print(d);"
            "print(jax.config.jax_compilation_cache_dir)")
    if env_dir is None:
        r = _run(code, {"JAX_PLATFORMS": "cpu"},
                 unset=("JAX_COMPILATION_CACHE_DIR",))
        want = os.path.join(ROOT, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        r = _run(code, {"JAX_PLATFORMS": "cpu",
                        "JAX_COMPILATION_CACHE_DIR": want})
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == [want, want]
    if env_dir is None:
        gi = open(os.path.join(ROOT, ".gitignore")).read().split()
        assert ".jax_cache/" in gi


# ------------------------------------------------ chip_smoke device check


@pytest.mark.parametrize("how", ["cpu_platform", "card_hidden", "bare_dir"])
def test_chip_smoke_refuses_without_gpu(tmp_path, how):
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd, env, unset = ROOT, {"JAX_PLATFORMS": "cpu"}, ()
    if how != "cpu_platform":
        env, unset = {"CUDA_VISIBLE_DEVICES": ""}, ("JAX_PLATFORMS",)
    if how == "bare_dir":
        bare = tmp_path / "bare"
        bare.mkdir()
        script = str(bare / "chip_smoke.py")
        with open(script, "w") as f:
            f.write(open(os.path.join(ROOT, "chip_smoke.py")).read())
        cwd = str(bare)
    r = _run([script], env, unset=unset, cwd=cwd,
             repo_on_path=how != "bare_dir")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "chip_smoke:" in r.stderr
