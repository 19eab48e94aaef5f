"""The port's potential-flow oracle, MJPEG AVI writer and free-surface
video against the JAX package's modules, on the CPU.

The potential-flow and AVI tests of the JAX package (its reference
oracles, tests/test_potential_flow.py and tests/test_avi.py) run on the
port's copies here. The copies are held bitwise: the same inputs give a
byte-equal CSV and AVI, and `generate_video` of both packages on one tiny
case run by the port (8×8×10, 0.1 s, three snapshots) renders
pixel-equal frames; the dashboard is replaced by a recorder in both
video runs and compared on its own at duration 0.25 s, 8 fps (two
frames; the 80-frame default costs ~15 s).
"""

import io
import os
import struct
import unittest.mock as mock

import numpy as np
import pytest

from openfoam_tpp_tpu.post import avi as javi
from openfoam_tpp_tpu.post import video as jvideo
from openfoam_tpp_tpu.utils import potential_flow as jpf
from openfoam_tpp_tpu_torch.manager import cli as tcli
from openfoam_tpp_tpu_torch.manager.cases import setup_case
from openfoam_tpp_tpu_torch.manager.runner import run_case
from openfoam_tpp_tpu_torch.post import avi as tavi
from openfoam_tpp_tpu_torch.post import video as tvideo
from openfoam_tpp_tpu_torch.utils import potential_flow as pf

TINY = dict(H=0.04, D=0.02, mesh=0.004, geo="flat", R=0.002, freq=3.0,
            duration=0.1, dt=0.0005, ramp=-1)


# ---------------------------------------------------- potential flow oracles

def test_wall_amplitude_matches_reference_oracle():
    """The shipped production case's potential-flow output
    (post_flow.117896.out): R=0.1, a=0.004, f=1.88, d=0.104 =>
    A_PT = 3.146940e-02 m, Δh = 6.293879e-02 m, F = 0.056894."""
    s = pf.predict(R=0.1, a=0.004, freq=1.88, d=0.104, n_modes=30)
    assert abs(s["F"] - 0.056894) < 1e-6
    assert abs(s["A_PT"] - 3.146940e-02) < 1e-7
    assert abs(s["Delta_h_PT"] - 6.293879e-02) < 2e-7
    assert abs(s["omega"] - 11.8124) < 1e-4
    assert s == jpf.predict(R=0.1, a=0.004, freq=1.88, d=0.104, n_modes=30)


def test_natural_frequencies_formula():
    omega_n, eps = pf.natural_frequencies(R=0.1, d=0.104, n_modes=5)
    assert abs(eps[0] - 1.8412) < 1e-4
    lam = eps[0] / 0.1
    assert abs(omega_n[0] - np.sqrt(9.81 * lam * np.tanh(lam * 0.104))) < 1e-10


def test_exact_roots_close_to_table():
    pytest.importorskip("scipy")
    exact = pf.bessel_j1prime_zeros(5, root_mode="exact")
    table = pf.bessel_j1prime_zeros(5, root_mode="reference")
    assert np.allclose(exact, table, atol=5e-4)


def test_csv_schema_and_bytes(tmp_path):
    out, summary = pf.generate_wall_elevation_csv(
        str(tmp_path), R=0.1, a=0.004, freq=1.88, d=0.104,
        duration=0.1, dt=0.05, n_theta=8,
    )
    lines = open(out).read().strip().split("\n")
    assert lines[0] == "time,theta,zeta_wall"
    n_times = len(np.arange(0.0, 0.1 + 0.05, 0.05))
    assert len(lines) == 1 + n_times * 8
    t0, th0, z0 = lines[1].split(",")
    assert t0 == "0.000000" and th0 == "0.000000"
    assert abs(float(z0) - summary["A_PT"]) < 1e-9
    os.makedirs(tmp_path / "jax")
    jout, jsummary = jpf.generate_wall_elevation_csv(
        str(tmp_path / "jax"), R=0.1, a=0.004, freq=1.88, d=0.104,
        duration=0.1, dt=0.05, n_theta=8)
    assert open(out, "rb").read() == open(jout, "rb").read()
    assert {k: v for k, v in summary.items() if k != "output_file"} == {
        k: v for k, v in jsummary.items() if k != "output_file"}


def test_wall_elevation_rotates_with_orbit():
    a_pt, omega = 0.01, 2.0
    th = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    z0 = pf.wall_elevation(th, 0.0, a_pt, omega)
    t1 = 0.7
    z1 = pf.wall_elevation(th, t1, a_pt, omega)
    assert np.argmax(z1) == np.argmin(np.abs(((th - omega * t1 + np.pi)
                                              % (2 * np.pi)) - np.pi))
    assert abs(z0.max() - a_pt) < 1e-12


# ------------------------------------------------------------- AVI writer

def _frames(n=5, h=48, w=64):
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        f = np.zeros((h, w, 3), np.uint8)
        f[:, :, 0] = 10 * i
        f[10:20, 10 + i * 5 : 20 + i * 5, 1] = 255
        f += rng.integers(0, 8, (h, w, 3), dtype=np.uint8)
        out.append(f)
    return out


def test_container_structure_and_bytes(tmp_path):
    frames = _frames()
    path = tavi.write_mjpeg_avi(str(tmp_path / "v.avi"), frames, fps=30)
    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] + 8 == len(data)
    assert data[12:16] == b"LIST" and data[20:24] == b"hdrl"
    assert data[24:28] == b"avih"
    fields = struct.unpack("<14I", data[32:32 + 56])
    assert fields[4] == len(frames)
    assert (fields[8], fields[9]) == (64, 48)
    assert b"MJPG" in data[:300]
    assert b"movi" in data and b"idx1" in data
    jpath = javi.write_mjpeg_avi(str(tmp_path / "j.avi"), frames, fps=30)
    assert data == open(jpath, "rb").read()


def test_frames_decode_roundtrip(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    frames = _frames()
    path = tavi.write_mjpeg_avi(str(tmp_path / "v.avi"), frames, fps=10,
                                quality=95)
    data = open(path, "rb").read()
    pos = data.index(b"movi") + 4
    decoded = []
    while data[pos : pos + 4] == b"00dc":
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        jpeg = data[pos + 8 : pos + 8 + size]
        decoded.append(np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB")))
        pos += 8 + size + (size % 2)
    assert len(decoded) == len(frames)
    for src, dec in zip(frames, decoded):
        assert dec.shape == src.shape
        assert np.mean(np.abs(dec.astype(int) - src.astype(int))) < 6.0


def test_save_video_falls_back_to_avi(tmp_path):
    out = tavi.save_video(str(tmp_path / "anim.mp4"), _frames(3), fps=5)
    assert out.endswith((".mp4", ".avi"))
    head = open(out, "rb").read(12)
    assert head[:4] == b"RIFF" or head[4:8] == b"ftyp"


def test_save_video_mp4_decodes_roundtrip(tmp_path):
    cv2 = pytest.importorskip("cv2")
    frames = _frames(6)
    out = tavi.save_video(str(tmp_path / "anim.mp4"), frames, fps=10)
    assert out.endswith(".mp4")
    cap = cv2.VideoCapture(out)
    assert cap.isOpened()
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == len(frames)
    ok, fr = cap.read()
    cap.release()
    assert ok and fr.shape == frames[0].shape
    dec = fr[..., ::-1].astype(int)
    assert np.mean(np.abs(dec - frames[0].astype(int))) < 12.0


# ------------------------------------------------------------------ video

@pytest.fixture(scope="module")
def tiny_case(tmp_path_factory):
    """The tiny case run by the port: checkpoints at 0, 0.05 and 0.1."""
    base = tmp_path_factory.mktemp("video")
    case = setup_case(TINY, str(base))
    run_case(case, device="cpu", log=lambda *a: None)
    return case


def _render(video_mod, avi_mod, pf_mod, case_dir):
    """generate_video with the encoder and the dashboard recorded."""
    pytest.importorskip("matplotlib")
    saved, dashes = [], []

    def save(path, frames, fps=30, log=print):
        saved.append((os.path.basename(path), fps, list(frames)))
        return path

    with mock.patch.object(avi_mod, "save_video", save), \
            mock.patch.object(pf_mod, "generate_dashboard_animation",
                              lambda path, **k: dashes.append(k)
                              or (path, {})):
        assert video_mod.generate_video(case_dir)
    return saved, dashes


def test_video_frames_pixel_equal_to_jax(tiny_case):
    got, got_dash = _render(tvideo, tavi, pf, tiny_case)
    want, want_dash = _render(jvideo, javi, jpf, tiny_case)
    assert [(n, fps) for n, fps, _ in got] == [("animation.mp4", 30)]
    assert [(n, fps) for n, fps, _ in want] == [("animation.mp4", 30)]
    frames, jframes = got[0][2], want[0][2]
    assert len(frames) == len(jframes) == 3
    for f, j in zip(frames, jframes):
        assert f.dtype == np.uint8 and f.shape == j.shape
        assert np.array_equal(f, j)
    assert got_dash == want_dash == [dict(R=0.01, a=0.002, freq=3.0, d=0.02)]


def test_tank_outline_as_jax(tiny_case):
    from openfoam_tpp_tpu_torch.manager.cases import load_case_params
    from openfoam_tpp_tpu_torch.manager.runner import build_case_geometry
    from openfoam_tpp_tpu_torch.mesh import build_box_geometry

    params = load_case_params(tiny_case)
    for geom in (build_case_geometry(params),
                 build_box_geometry(0.2, 0.1, 0.3, 0.05, z0=-0.15)):
        got, want = tvideo._tank_outline(geom, params), \
            jvideo._tank_outline(geom, params)
        for g, w in zip(got, want):
            assert len(g) == len(w)
            assert all(np.array_equal(a, b) for a, b in zip(g, w))


def test_dashboard_pixel_equal_to_jax(tmp_path):
    pytest.importorskip("matplotlib")
    got, want = [], []
    kw = dict(R=0.1, a=0.004, freq=1.88, d=0.104, duration=0.25, fps=8)
    with mock.patch.object(tavi, "save_video",
                           lambda p, f, fps=30: got.append((fps, f)) or p):
        out, summary = pf.generate_dashboard_animation(
            str(tmp_path / "t.mp4"), **kw)
    with mock.patch.object(javi, "save_video",
                           lambda p, f, fps=30: want.append((fps, f)) or p):
        jout, jsummary = jpf.generate_dashboard_animation(
            str(tmp_path / "j.mp4"), **kw)
    assert summary == jsummary and out.endswith("t.mp4")
    assert [(fps, len(f)) for fps, f in got] == [(8, 2)] == [
        (fps, len(f)) for fps, f in want]
    for f, j in zip(got[0][1], want[0][1]):
        assert np.array_equal(f, j)


def test_video_verb_refuses_without_matplotlib(tiny_case, monkeypatch,
                                               capsys):
    """As the JAX package's: without matplotlib the verb prints the
    refusal and the command exits 1."""
    monkeypatch.setattr(tvideo, "_have", lambda mod: mod != "matplotlib")
    assert tcli.main(["--headless", "--base-dir", os.path.dirname(tiny_case),
                      "--case", os.path.basename(tiny_case), "--action",
                      "video"]) == 1
    assert "matplotlib not available" in capsys.readouterr().out
