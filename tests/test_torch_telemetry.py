"""The port's ingestion modules (``data/telemetry.py``, ``data/video.py``,
``data/download.py``) against the JAX package's, on the CPU.

- CAMM (types 5 and 6, non-GPS types skipped), GPMF (GPS5 scaled by
  SCAL), BlackVue (bracketed NMEA in ``free`` boxes), the ``auto``
  dispatch over files, a camm parse of a gpmd file and back, exiftool's
  RDF/XML and ``parse_geotag_file``'s dispatch, GPX, NMEA and
  ``interpolate_geotags``: the same tracks and descriptions as JAX's
  (equal, not close: both are the same stdlib code), on the byte writers
  of ``tests/test_telemetry.py`` and the inputs of
  ``tests/test_models.py``'s ``TestVideo`` / ``TestNMEA``.
- ``extract_frames`` raises without an ``ffmpeg`` binary on the PATH;
  ``process_video`` (frames stubbed, as no test may need ffmpeg) writes
  the same ``image_descriptions.json`` and exif JSONs as JAX's, through
  the port's own ``ImageProcessor``.
- ``download`` unpacks a zip from a ``file://`` URL, and a second call
  fetches nothing (the archive is there).
"""

import os
import struct
import zipfile

import pytest

from splat_one_tpu.data import telemetry as JT
from splat_one_tpu.data import video as JV
from splat_one_tpu_torch.data import download as TD
from splat_one_tpu_torch.data import telemetry as TT
from splat_one_tpu_torch.data import video as TV
from test_telemetry import _box, _camm_sample5, _camm_sample6, _gpmf_sample, _make_mp4, _rmc

GPX = """<?xml version="1.0"?>
<gpx xmlns="http://www.topografix.com/GPX/1/1" version="1.1">
<trk><trkseg>
<trkpt lat="35.0" lon="139.0"><ele>10</ele><time>2024-01-01T00:00:00Z</time></trkpt>
<trkpt lat="35.001" lon="139.001"><ele>20</ele><time>2024-01-01T00:01:00Z</time></trkpt>
</trkseg></trk></gpx>"""

NMEA = ("$GPGGA,120001.00,4807.038,N,01131.000,E,1,08,0.9,545.4,M,46.9,M,,*47\n"
        "$GPRMC,120001.00,A,4807.038,N,01131.000,E,022.4,084.4,230324,003.1,W*6A\n"
        "$GPRMC,120003.00,A,4807.100,N,01131.100,E,022.4,084.4,230324,003.1,W*6A\n"
        "garbage line\n"
        "$GPRMC,120002.00,V,,,,,,,230324,,*00\n")

XML = """<?xml version='1.0'?>
<rdf:RDF xmlns:rdf='http://www.w3.org/1999/02/22-rdf-syntax-ns#'
         xmlns:Track3='http://ns.exiftool.org/QuickTime/Track3/1.0/'>
 <rdf:Description>
  <Track3:GPSDateTime>2021:06:07 12:00:00.000Z</Track3:GPSDateTime>
  <Track3:GPSLatitude>35 deg 30' 0.00" N</Track3:GPSLatitude>
  <Track3:GPSLongitude>139 deg 15' 0.00" E</Track3:GPSLongitude>
  <Track3:GPSAltitude>12.3 m</Track3:GPSAltitude>
  <Track3:GPSDateTime>2021:06:07 12:00:01.000Z</Track3:GPSDateTime>
  <Track3:GPSLatitude>35.6</Track3:GPSLatitude>
  <Track3:GPSLongitude>139.35</Track3:GPSLongitude>
  <Track3:GPSAltitude>13.3 m</Track3:GPSAltitude>
 </rdf:Description>
</rdf:RDF>"""


def _camm6():
    return _make_mp4(b"camm", [_camm_sample6(1e9 + i, 35.0 + i * 1e-3, 139.0 + i * 1e-3,
                                             40.0 + i) for i in range(3)])


def _camm_mixed():
    gyro = struct.pack("<HH", 0, 2) + struct.pack("<fff", 0, 0, 0)
    return _make_mp4(b"camm", [gyro, _camm_sample5(1.0, 2.0, 3.0), gyro,
                               _camm_sample5(-12.5, 45.25, 100.0)])


def _gpmf():
    return _make_mp4(b"gpmd", [_gpmf_sample([(35.1, 139.2, 12.0), (35.2, 139.3, 13.0)]),
                               _gpmf_sample([(35.3, 139.4, 14.0)])])


def _blackvue():
    lines = (_rmc(1623057074000, 35.5, 139.25)
             + b"[1623057074000]$GPGGA,120000.00,,,,,1,08,1.0,42.5,M,,,,*00\r\n"
             + _rmc(1623057075000, -35.6, -139.35))
    return _box(b"ftyp", b"mp42") + _box(b"free", lines) + _box(b"mdat", b"\x00" * 32)


BYTES_CASES = {
    "camm type 6": ("parse_camm_bytes", _camm6),
    "camm types 5 and gyro": ("parse_camm_bytes", _camm_mixed),
    "gpmf": ("parse_gpmf_bytes", _gpmf),
    "camm over gpmd": ("parse_camm_bytes", _gpmf),
    "gpmf over camm": ("parse_gpmf_bytes", _camm6),
    "blackvue": ("parse_blackvue_bytes", _blackvue),
}


@pytest.mark.parametrize("case", sorted(BYTES_CASES))
def test_bytes_parsers_equal(case):
    fn, build = BYTES_CASES[case]
    data = build()
    want = getattr(JT, fn)(data)
    assert getattr(TT, fn)(data) == want
    if case in ("camm type 6", "gpmf", "blackvue"):
        assert len(want) >= 2


@pytest.mark.parametrize("source", ["auto", "camm", "gopro", "blackvue"])
@pytest.mark.parametrize("build", [_camm6, _gpmf, _blackvue])
def test_video_geotags_equal(tmp_path, source, build):
    p = tmp_path / "v.mp4"
    p.write_bytes(build())
    assert TT.parse_video_geotags(str(p), source) == JT.parse_video_geotags(str(p), source)


@pytest.mark.parametrize("name,text", [("t.gpx", GPX), ("track.nmea", NMEA), ("v.xml", XML)])
def test_geotag_files_equal(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    want = JV.parse_geotag_file(str(p))
    assert len(want) == 2
    assert TV.parse_geotag_file(str(p)) == want
    if name.endswith(".xml"):
        assert TT.parse_exiftool_xml(str(p)) == JT.parse_exiftool_xml(str(p))
    times = [want[0]["time_s"] - 1.0, want[0]["time_s"] + 0.5, want[-1]["time_s"] + 1.0]
    names = ["a.jpg", "b.jpg", "c.jpg"]
    assert TV.interpolate_geotags(names, times, want) == JV.interpolate_geotags(
        names, times, want)


def test_extract_frames_needs_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # no ffmpeg binary on it
    assert not TV.ffmpeg_available()
    with pytest.raises(RuntimeError, match="ffmpeg"):
        TV.extract_frames(str(tmp_path / "clip.mp4"), str(tmp_path / "frames"))


@pytest.mark.parametrize("source", ["file", "auto"])
def test_process_video_geotags_equal(tmp_path, monkeypatch, source):
    """Frames stubbed (three names at interval 2 s); the GPX sidecar for
    "file", the embedded CAMM track for "auto"."""
    def frames(video_path, out_dir, interval_s=2.0, prefix=None):
        os.makedirs(out_dir, exist_ok=True)
        return [f"clip_{i:06d}.jpg" for i in range(1, 4)]

    gpx = tmp_path / "t.gpx"
    gpx.write_text(GPX)
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(_camm6())
    out = {}
    for name, mod in (("jax", JV), ("port", TV)):
        monkeypatch.setattr(mod, "extract_frames", frames)
        wd = tmp_path / name
        n = mod.process_video(str(clip), str(wd), gpx_path=str(gpx), geotag_source=source)
        assert n == 3
        out[name] = {f: (wd / f).read_bytes() for f in
                     ["image_descriptions.json"] + [f"exif/clip_{i:06d}.jpg.exif"
                                                    for i in range(1, 4)]}
    assert out["port"] == out["jax"]


def test_download_from_file_url(tmp_path, monkeypatch):
    src = tmp_path / "src" / "scene.zip"
    src.parent.mkdir()
    with zipfile.ZipFile(src, "w") as z:
        z.writestr("scene/images/a.txt", "x")
    monkeypatch.setitem(TD.DATASETS, "local", [src.as_uri()])
    dst = tmp_path / "data"
    TD.download("local", str(dst))
    assert (dst / "scene.zip").read_bytes() == src.read_bytes()
    assert (dst / "scene" / "images" / "a.txt").read_text() == "x"

    def no_fetch(*a):
        raise AssertionError("fetched an archive that is already there")

    import urllib.request

    monkeypatch.setattr(urllib.request, "urlretrieve", no_fetch)
    (dst / "scene" / "images" / "a.txt").unlink()
    TD.download("local", str(dst))
    assert (dst / "scene" / "images" / "a.txt").read_text() == "x"
